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
// Integer sums are exact in any order, so two launches, and the plain
// PyTorch version (integer index_add_), give identical bits. The wrapper
// recombines sum_k acc_k * 2^-(7+8k) * scale in float64.
//
// What the TPU workarounds were, and what is left of them: the TPU kernel
// stores the slices as bf16, builds a one-hot matrix per chunk in VMEM,
// contracts it on the MXU in f32 and carries a TwoSum hi/lo pair across
// chunks to keep the sums exact. Here the slices are made in registers
// from the float64 values (the 192 MB slice array that JAX writes between
// its XLA slicing and its kernel does not exist) and summed as integers.
//
// Bound on the card: reading values (M*D*8 B = 192 MB at M = 2e6, D = 12)
// and ids (16 MB) takes ~62 us at 3.35 TB/s. One int64 atomic per slice
// and value would be 96 atomics per point (1.9e8 at M = 2e6), onto the
// S*8*D counters in L2; atomics, not bytes, would bound it. The points
// arrive in trajectory order, so consecutive points mostly share a
// segment: each warp groups its lanes by segment id and sums every slice
// over a group with one warp reduction (__reduce_add_sync; |sum| <= 32 *
// 129 fits an int); lanes 0-7 then add the group's 8 slice sums, one
// atomic each. That cuts the atomics by the number of lanes per group.
//
// Overflow: a counter sums at most M slices of magnitude <= 129, so it
// stays below 2^53 (exact in the float64 recombination) for M < 2^45.

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

__global__ void segment_sum_kernel(const long long* __restrict__ ids,
                                   const double* __restrict__ values,
                                   const double* __restrict__ scale,
                                   unsigned long long* __restrict__ acc,
                                   long long M, int D, int S) {
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
        for (int d = 0; d < D; ++d) {
            int c[8];
            double r = valid ? values[m * D + d] / scale[d] : 0.0;
            double g = 128.0;                       // 2^(7+8k)
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const double ck = rint(r * g);
                c[k] = (int)ck;
                r = r - ck / g;
                g *= 256.0;
            }
            unsigned todo = live;
            while (todo) {
                const int leader = __ffs(todo) - 1;
                const long long seg = __shfl_sync(FULL_MASK, id, leader);
                const bool mine = valid && id == seg;
                todo &= ~__ballot_sync(FULL_MASK, mine);
                unsigned long long* out = acc + (size_t)seg * 8 * D + d;
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const int s = __reduce_add_sync(FULL_MASK, mine ? c[k] : 0);
                    if (lane == k)
                        atomicAdd(out + (size_t)k * D,
                                  (unsigned long long)(long long)s);
                }
            }
        }
    }
}

extern "C" int segment_sum_launch(const long long* ids, const double* values,
                                  const double* scale, long long* acc,
                                  long long M, int D, int S, void* stream) {
    if (M <= 0 || D <= 0) return 0;
    const int threads = 256;
    long long want = (M + threads - 1) / threads;
    int blocks = (int)(want < 4096 ? want : 4096);
    segment_sum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        ids, values, scale, (unsigned long long*)acc, M, D, S);
    return (int)cudaGetLastError();
}
