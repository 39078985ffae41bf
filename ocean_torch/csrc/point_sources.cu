// Fused point sources: b = sum_m gamma_m phi(x_m) onto the P2 half-grid
// image, deterministic to the bit.
//
// Replaces the Pallas TPU kernel
// ocean_jax/adjoint/pallas_psrc.py::_make_psrc_kernel (launched by
// _run_psrc): the transpose of interpolation over M = K*nt points. Each
// point is located on the half-grid (clamped, as in locate_points), its
// 3x3 P2 patch weights W are evaluated, and W * r is added into the
// (Hy*Hx, 2) image, where r = gamma / scale is gamma pre-divided by a
// per-component power of two (scale = 2^ceil(log2 max|gamma|), |r| <= 1;
// computed by the wrapper, exact). Any domain of grid.cuh: the obstacle
// needs nothing here, since a point with gamma != 0 lies in a cell (an
// escaped buoy's gamma is 0), and image nodes of removed squares are
// dropped by the caller's dof_to_node gather.
//
// Determinism. Float64 atomics sum in an order that changes from run to
// run. Instead each contribution v = W * r (|v| <= 1, |W| <= 1) is split
// into two fixed-point int64 limbs,
//     hi = floor(v * 2^40),   lo = rint((v * 2^40 - hi) * 2^40),
// both exact double operations (scaling by a power of two, the
// fractional part of a double, and rint). Integer addition is
// associative, so the limb sums are bit-identical whatever the order and
// whatever the grouping. The wrapper returns (hi * 2^-40 + lo * 2^-80) *
// scale.
// Error bound: each term loses at most 2^-81 * scale to rint, so a node
// summing n terms is within n * 2^-81 * scale of the exact sum of the
// float64 terms W * r (n = 2e6, scale = 1: 1e-18), plus one rounding of
// the final conversion (2^-53 relative). Overflow: |hi| <= 2^40 and
// 0 <= lo <= 2^40 per term, so 2^23 terms per node fit in int64.
//
// Bound on the card: reading the points and r (M*2*8 B each, 64 MB at
// M=2e6) takes ~19 us at 3.35 TB/s; the 65*65*2 image is tiny. One
// atomic per term would be up to 24 per point, 4.8e7 in all, onto 16,900
// addresses, and the lanes of one warp hit the same few of them: the
// atomic units, not the bytes, bound such a kernel (5.8 ms at M=2e6).
// What the design does about it:
//
// 1. Warp grouping by square (warp_groups.cuh). The points arrive in
//    trajectory order and one buoy moves a fraction of a square a step,
//    so the 32 lanes of a warp fall into a few squares. All lanes of a
//    square share the 3x3 patch, whatever their triangle (p2_weights
//    writes 0.0 where a triangle has no node). Each lane splits its
//    9 x 2 terms into limbs, and the limbs into pieces (step 2), once;
//    then, square by square, each piece is summed over the group's
//    lanes, lane i keeps the sums of term i, and lanes 0-17 add them:
//    36 atomics per group, no two lanes of one instruction on one
//    address, six neighbouring counters per patch row. Lanes with r == 0
//    join no group.
// 2. Sums in 32-bit pieces. __reduce_add_sync takes 32-bit integers and
//    a limb has 41 bits, so each limb q is cut exactly into
//    q = a * 2^20 + b, a = q >> 20 (arithmetic: floor), 0 <= b < 2^20;
//    |a| <= 2^20, so 32 lanes sum below 2^26 in either piece, and
//    sum(q) = sum(a) * 2^20 + sum(b) exactly. Each term still contributes
//    exactly its hi and lo, so the counters keep their bits.
// 3. Points and r are read as 16-byte double2.
// After these the kernel is bound by its warp sums (72 per group), not by
// atomics or bytes. Three alternatives were measured on the card and
// left out: summing the limbs whole with a long long shuffle butterfly
// instead of as pieces was 1.3-1.6x slower; skipping the terms that are
// zero in a whole group (a group inside one triangle leaves three of
// nine nodes untouched) costs a vote per term and gained nothing; and a
// per-block image in shared memory (135 KB at Nx=32) gained 3% where
// groups are long and lost 15% where they are short. The kernel asks for
// no shared memory.
//
// locate and p2_weights (grid.cuh) and --fmad=false keep every double
// operation in the plain version's order, so the limbs of each term, and
// with them the counters, equal the plain version's bit for bit.

#include "grid.cuh"
#include "warp_groups.cuh"

#define THREADS 256
#define TERMS 18                 // 3x3 patch nodes x 2 components

typedef unsigned long long u64;

// G: the geometry type, the domain of locate (grid.cuh); the squares of
// the L-shape's missing block are never a key, since locate projects out
// of them
template <class G>
__global__ void __launch_bounds__(THREADS)
point_sources_kernel(const double* __restrict__ pts,
                     const double* __restrict__ r, u64* __restrict__ acc_hi,
                     u64* __restrict__ acc_lo, long long M, int Hx, G g) {
    if constexpr (G::kGraded) {
        extern __shared__ double lines[];    // the grid lines, dynamic
        stage_lines(g, lines);
    }
    const int lane = threadIdx.x & 31;
    // the loop bound is uniform over the warp, so every lane reaches the
    // full-mask warp intrinsics below
    for (long long base =
             (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         base < M; base += (long long)gridDim.x * blockDim.x) {
        const long long m = base + lane;
        double r0 = 0.0, r1 = 0.0;
        if (m < M) {
            const double2 rr = reinterpret_cast<const double2*>(r)[m];
            r0 = rr.x;
            r1 = rr.y;
        }
        const bool live = !(r0 == 0.0 && r1 == 0.0);
        const unsigned live_mask = __ballot_sync(FULL_MASK, live);
        if (live_mask == 0) continue;

        // this lane's square and the pieces of the limbs of its 18 terms
        // (piece 0, 1: hi = a * 2^20 + b; piece 2, 3: lo likewise), cut
        // once
        long long key = -1;
        int piece[TERMS][4];
#pragma unroll
        for (int i = 0; i < TERMS; ++i)
            piece[i][0] = piece[i][1] = piece[i][2] = piece[i][3] = 0;
        if (live) {
            const double2 p = reinterpret_cast<const double2*>(pts)[m];
            const double px = p.x, py = p.y;
            int ix, iy;
            double s, t;
            locate(g, px, py, ix, iy, s, t);
            double W[9];
            p2_weights<G::kLeft>(s, t, W);
            key = (long long)iy * g.nx + ix;
#pragma unroll
            for (int j = 0; j < 9; ++j) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const double y = (W[j] * (c ? r1 : r0)) * 0x1p40;
                    const double fh = floor(y);
                    const long long qh = (long long)fh;
                    const long long ql = (long long)rint((y - fh) * 0x1p40);
                    int* q = piece[2 * j + c];
                    q[0] = (int)(qh >> 20);          // arithmetic: floor
                    q[1] = (int)(qh & 0xFFFFF);
                    q[2] = (int)(ql >> 20);
                    q[3] = (int)(ql & 0xFFFFF);
                }
            }
        }

        const unsigned my_group = lanes_sharing_key(live, key);
        for (unsigned todo = live_mask; todo != 0;) {
            int leader;
            const unsigned group = next_group(todo, my_group, leader);
            const bool mine = (group >> lane) & 1u;
            const long long square = __shfl_sync(FULL_MASK, key, leader);
            int sum[4] = {0, 0, 0, 0};            // of term `lane`
#pragma unroll
            for (int i = 0; i < TERMS; ++i) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int total = __reduce_add_sync(
                        FULL_MASK, mine ? piece[i][k] : 0);
                    if (lane == i) sum[k] = total;
                }
            }
            const long long sum_hi = sum[0] * (1LL << 20) + sum[1];
            const long long sum_lo = sum[2] * (1LL << 20) + sum[3];
            if (lane < TERMS && (sum_hi | sum_lo) != 0) {
                const int j = lane >> 1;          // patch node (b, a)
                const int iy = (int)(square / g.nx);
                const int ix = (int)(square - (long long)iy * g.nx);
                const size_t node = (size_t)(2 * iy + j / 3) * Hx +
                                    2 * ix + j % 3;
                const size_t at = 2 * node + (lane & 1);
                atomicAdd(acc_hi + at, (u64)sum_hi);
                atomicAdd(acc_lo + at, (u64)sum_lo);
            }
        }
    }
}

extern "C" int point_sources_launch(const double* pts, const double* r,
                                    long long* acc_hi, long long* acc_lo,
                                    long long M, int Hx, Geom g,
                                    void* stream) {
    if (M <= 0) return 0;
    const long long want = (M + THREADS - 1) / THREADS;
    const int blocks = (int)(want < 65535 ? want : 65535);
    return with_geom(g, [&](auto geom) {
        point_sources_kernel<<<blocks, THREADS, lines_bytes(geom),
                               (cudaStream_t)stream>>>(
            pts, r, (u64*)acc_hi, (u64*)acc_lo, M, Hx, geom);
        return (int)cudaGetLastError();
    });
}
