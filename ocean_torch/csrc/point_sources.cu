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
// computed by the wrapper, exact).
//
// Determinism. Float64 atomics sum in an order that changes from run to
// run. Instead each contribution v = W * r (|v| <= 1, |W| <= 1) is split
// into two fixed-point int64 limbs,
//     hi = floor(v * 2^40),   lo = rint((v * 2^40 - hi) * 2^40),
// both exact double operations (scaling by a power of two, the
// fractional part of a double, and rint). Integer atomicAdd is
// associative, so the limb sums are bit-identical whatever the order.
// The wrapper returns (hi * 2^-40 + lo * 2^-80) * scale.
// Error bound: each term loses at most 2^-81 * scale to rint, so a node
// summing n terms is within n * 2^-81 * scale of the exact sum of the
// float64 terms W * r (n = 2e6, scale = 1: 1e-18), plus one rounding of
// the final conversion (2^-53 relative). Overflow: |hi| <= 2^40 and
// 0 <= lo <= 2^40 per term, so 2^23 terms per node fit in int64.
//
// Bound on the card: reading the points and gamma (M*2*8 B each, 64 MB
// at M=2e6) takes ~19 us at 3.35 TB/s; the 65*65*2 image is tiny. The
// kernel issues up to 24 integer atomics per point into 16,900 addresses
// in L2, so contention on the atomic units, not bandwidth, bounds it. A
// per-block shared-memory image (135 KB at Nx=32) would cut the global
// atomics ~100x; that is left to a later change.

#include "grid.cuh"

__device__ __forceinline__ void add_limbs(unsigned long long* hi,
                                          unsigned long long* lo, double v) {
    double y = v * 0x1p40;
    double qh = floor(y);
    double ql = rint((y - qh) * 0x1p40);
    atomicAdd(hi, (unsigned long long)(long long)qh);
    atomicAdd(lo, (unsigned long long)(long long)ql);
}

__global__ void point_sources_kernel(const double* __restrict__ pts,
                                     const double* __restrict__ r,
                                     unsigned long long* __restrict__ acc_hi,
                                     unsigned long long* __restrict__ acc_lo,
                                     long long M, int Hx, Geom g) {
    for (long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         m < M; m += (long long)gridDim.x * blockDim.x) {
        double r0 = r[2 * m], r1 = r[2 * m + 1];
        if (r0 == 0.0 && r1 == 0.0) continue;
        int ix, iy;
        double s, t;
        locate(g, pts[2 * m], pts[2 * m + 1], ix, iy, s, t);
        double W[9];
        p2_weights(s, t, W);
        size_t base = (size_t)(2 * iy) * Hx + 2 * ix;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                double w = W[3 * b + a];
                if (w == 0.0) continue;
                size_t node = base + (size_t)b * Hx + a;
                double v0 = w * r0, v1 = w * r1;
                if (v0 != 0.0) add_limbs(acc_hi + 2 * node, acc_lo + 2 * node, v0);
                if (v1 != 0.0)
                    add_limbs(acc_hi + 2 * node + 1, acc_lo + 2 * node + 1, v1);
            }
        }
    }
}

extern "C" int point_sources_launch(const double* pts, const double* r,
                                    long long* acc_hi, long long* acc_lo,
                                    long long M, int Hx, Geom g,
                                    void* stream) {
    if (M <= 0) return 0;
    const int threads = 256;
    long long want = (M + threads - 1) / threads;
    int blocks = (int)(want < 65535 ? want : 65535);
    point_sources_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pts, r, (unsigned long long*)acc_hi, (unsigned long long*)acc_lo, M,
        Hx, g);
    return (int)cudaGetLastError();
}
