// Ozaki segment sum: exact per-segment sums of the 8 integer slices of
// float64 values.
//
// Replaces the Pallas TPU kernel ocean_jax/ops/psum_pallas.py::_kernel
// (launched in ozaki_segment_sum_pallas). For values v (M, D) with segment
// ids (M,) in [0, S] (id == S is a dropped padding bin) and a per-column
// power of two scale >= max|v| (computed by the wrapper), each value is
// cut into 8 integer slices, as ocean_jax/ops/scatter.py does:
//
//     r = v / scale;  for k = 0..7:  c_k = rint(r * 2^(7+8k)),
//                                    r   = r - c_k / 2^(7+8k)
//
// (rint is round-half-even, like jnp.round; |c_k| <= 2^7 + 1, so an int
// holds it). The kernel adds up each slice per segment as an integer,
// acc[s][k][d] = sum over {m : id_m = s} of c_k(v[m][d]), into int64.
// Integer sums are exact in any order and any grouping, so two launches,
// and the plain PyTorch version (integer index_add_), give identical
// bits. The wrapper recombines sum_k acc_k * 2^-(7+8k) * scale in float64.
//
// What the TPU workarounds were, and what is left of them: the TPU kernel
// stores the slices as bf16, builds a one-hot matrix per chunk in VMEM,
// contracts it on the MXU in f32 and carries a TwoSum hi/lo pair across
// chunks to keep the sums exact. Here the slices are made in registers
// from the float64 values (the 192 MB slice array that JAX writes between
// its XLA slicing and its kernel does not exist) and summed as integers.
//
// Bound on the card: reading values (M*D*8 B = 192 MB at M = 2e6, D = 12)
// and ids (16 MB) takes ~62 us at 3.35 TB/s. The slicing is 4 float64
// operations per slice, 7.7e8 at these sizes: ~52 us at the card's
// float64 add/multiply rate (half its FMA rate), so arithmetic and bytes
// weigh about the same and neither may be wasted. The S*8*D counters
// (1.5 MB) live in L2. What the design does:
//
// * No division, no conversion. scale and 2^(7+8k) are powers of two, so
//   multiplying by the exact reciprocal (1/scale from the wrapper, a
//   constant per k) is the same real number rounded once: the same bits
//   as dividing. Only a scale below 2^-1023 has no finite reciprocal;
//   its column is divided (a uniform branch, never taken by pow2_scale's
//   output for normal data). rint and the float->int conversion run at a
//   quarter of the float64 rate on this card. Instead t = x + 1.5*2^52
//   rounds x (|x| <= 129) to an integer, half to even, in the adder (the
//   ulp of t is 1 and 1.5*2^52 is even, so ties go to the even integer
//   exactly as rint's), the low 32 bits of t are that integer in two's
//   complement, and t - 1.5*2^52 is its float64 value: two additions, no
//   conversion, the same integers.
// * Loads by the sector. The columns go four at a time (below), so a
//   lane reads 32 contiguous bytes of its row per pass: every sector that
//   is fetched is used whole, although neighbouring lanes are 8*D bytes
//   apart. Two alternatives were measured and left out: 16-byte loads
//   gained nothing, and staging a warp's 32 rows through a padded
//   shared-memory tile with fully coalesced loads was 12% slower.
// * Grouping once, sums packed. The points arrive in trajectory order,
//   so the lanes of a warp fall into a few segments. The partition by id
//   is found once per 32 points (warp_groups.cuh), not once per column.
//   Two slices are packed into one int, p = c_a + c_b * 2^16, before the
//   warp sum: |sum c| <= 32 * 129 < 2^15, so the low 16 bits of sum(p),
//   read as a signed 16-bit number, are sum(c_a), and what remains is
//   sum(c_b) * 2^16 exactly. That is 4 __reduce_add_sync per column and
//   group instead of 8. A warp that is one segment takes the group loop
//   once.
// * Atomics by the sector. What is left is bound by the atomics: one per
//   slice, column and group. L2 serves an atomic instruction sector by
//   sector (32 bytes), so the columns go four at a time: lane k*4 + j
//   keeps the sum of slice k of column d0 + j, and the group's 32 sums
//   go out in one instruction in which four neighbouring lanes share a
//   sector of acc[seg][k][d0..d0+3]. A sum that is zero (the last slices
//   of a value lie below its mantissa) is not added at all.
//
// Overflow: a counter sums at most M slices of magnitude <= 129, so it
// stays below 2^53 (exact in the float64 recombination) for M < 2^45.

#include <cuda_runtime.h>

#include "warp_groups.cuh"

#define SLICES 8
#define THREADS 256
#define NSUMS (SLICES / 2)       // packed warp sums per column
#define COLS 4                   // columns per pass: COLS * SLICES = 32 lanes

typedef unsigned long long u64;

// The 8 slices of r (|r| <= 1), as the formula in the head note.
__device__ __forceinline__ void slice(double r, int* c) {
    double g = 0x1p7, g_inv = 0x1p-7;         // 2^(7+8k) and its reciprocal
#pragma unroll
    for (int k = 0; k < SLICES; ++k) {
        const double t = r * g + 0x1.8p52;
        c[k] = __double2loint(t);
        r = r - (t - 0x1.8p52) * g_inv;
        g *= 0x1p8;
        g_inv *= 0x1p-8;
    }
}

__global__ void segment_sum_kernel(const long long* __restrict__ ids,
                                   const double* __restrict__ values,
                                   const double* __restrict__ scale,
                                   const double* __restrict__ inv_scale,
                                   u64* __restrict__ acc, long long M, int D,
                                   int S) {
    const int lane = threadIdx.x & 31;
    const long long warp =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
    // the loop bound is uniform over the warp, so every lane reaches the
    // full-mask warp intrinsics below
    for (long long base = warp * 32; base < M; base += nwarps * 32) {
        const long long m = base + lane;
        const long long id = m < M ? ids[m] : (long long)S;
        const bool valid = id >= 0 && id < S;
        const unsigned live = __ballot_sync(FULL_MASK, valid);
        if (live == 0) continue;

        const unsigned my_group = lanes_sharing_key(valid, id);
        // lane = k * COLS + j adds slice k of column d0 + j, one half of
        // packed sum k / 2
        const int k = lane / COLS, j_mine = lane % COLS;
        const int sum_mine = (k >> 1) * COLS + j_mine;
        for (int d0 = 0; d0 < D; d0 += COLS) {
            double v[COLS] = {0.0, 0.0, 0.0, 0.0};
            if (valid) {
#pragma unroll
                for (int j = 0; j < COLS; ++j)
                    if (d0 + j < D) v[j] = values[m * D + d0 + j];
            }
            int p[COLS][NSUMS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
                const int d = d0 + j;
                double r = 0.0;
                if (valid && d < D) {
                    const double inv = inv_scale[d];
                    r = isinf(inv) ? v[j] / scale[d] : v[j] * inv;
                }
                int c[SLICES];
                slice(r, c);
#pragma unroll
                for (int i = 0; i < NSUMS; ++i)
                    p[j][i] = c[2 * i] + c[2 * i + 1] * 65536;
            }

            for (unsigned todo = live; todo != 0;) {
                int leader;
                const unsigned group = next_group(todo, my_group, leader);
                const bool mine = (group >> lane) & 1u;
                const long long seg = __shfl_sync(FULL_MASK, id, leader);
                int sum = 0;
#pragma unroll
                for (int j = 0; j < COLS; ++j) {
                    if (d0 + j >= D) break;           // uniform
#pragma unroll
                    for (int i = 0; i < NSUMS; ++i) {
                        const int s = __reduce_add_sync(
                            FULL_MASK, mine ? p[j][i] : 0);
                        if (sum_mine == i * COLS + j) sum = s;
                    }
                }
                const int low = (int)(short)(sum & 0xFFFF);
                sum = (k & 1) ? (sum - low) / 65536 : low;
                if (d0 + j_mine < D && sum != 0)
                    atomicAdd(acc + ((size_t)seg * SLICES + k) * D + d0 +
                                  j_mine,
                              (u64)(long long)sum);
            }
        }
    }
}

extern "C" int segment_sum_launch(const long long* ids, const double* values,
                                  const double* scale,
                                  const double* inv_scale, long long* acc,
                                  long long M, int D, int S, void* stream) {
    if (M <= 0 || D <= 0) return 0;
    const long long want = (M + THREADS - 1) / THREADS;
    const int blocks = (int)(want < 4096 ? want : 4096);
    segment_sum_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        ids, values, scale, inv_scale, (u64*)acc, M, D, S);
    return (int)cudaGetLastError();
}
