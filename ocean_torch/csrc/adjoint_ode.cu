// Adjoint buoy ODE: the whole backward mu recursion of every buoy in one
// launch.
//
// Replaces the Pallas TPU kernel
// ocean_jax/ode/pallas_adjoint.py::_make_adjoint_kernel (launched by
// _run_adjoint). Per buoy, mu[nt-1] = 0 and for k = nt-2 .. 0
//
//     mu[k] = mu[k+1] - h grad_u(x[k+1])^T ((u - u_d)[k+1] - mu[k+1])
//
// with grad_u read from the 2x2 P1 patch of the projected-gradient vertex
// image. The kernel carries the last in-domain grad_u (the reference's
// reuse-previous quirk, starting from zeros) and zeroes the grad_u factor
// outside the window t <= vlimit (vlimit = nt: unrestricted), as the TPU
// kernel does. Escaped buoys are masked to mu = 0 by the caller.
// Native float64 replaces the TPU's double-single pairs and one-hot MXU
// row selection.
//
// Bound on the card: one thread per buoy runs a dependent 199-step chain
// (latency-bound). The bytes it must move are x and u - u_d in and mu out,
// K*nt*2*8 B each (48 MB at K=1e4, nt=200: ~14 us at 3.35 TB/s). The
// buoy-major (K, nt, 2) layout makes each thread's reads strided across
// the warp (16 B per thread per step); consecutive steps of one thread
// share cache lines, so L1 absorbs most of the waste.
//
// Built with --fmad=false (see grid.cuh).

#include "grid.cuh"

__global__ void adjoint_ode_kernel(const double* __restrict__ g_img,
                                   const double* __restrict__ x,
                                   const double* __restrict__ resid,
                                   const int* __restrict__ vlimit,
                                   double* __restrict__ mu, int K, int nt,
                                   int Gx, Geom g, double h) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const double* xk = x + (size_t)k * nt * 2;
    const double* rk = resid + (size_t)k * nt * 2;
    double* mk = mu + (size_t)k * nt * 2;
    mk[2 * (nt - 1)] = 0.0;
    mk[2 * (nt - 1) + 1] = 0.0;
    double mu1 = 0.0, mu2 = 0.0;
    double gc[4] = {0.0, 0.0, 0.0, 0.0};
    const int vl = vlimit[k];
    for (int kc = nt - 2; kc >= 0; --kc) {
        const int t = kc + 1;
        double px = xk[2 * t], py = xk[2 * t + 1];
        bool inside = in_domain(g, px, py);
        int ix, iy;
        double s, tl;
        locate(g, px, py, ix, iy, s, tl);
        double W[4];
        p1_weights(s, tl, W);
        double ge[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            double acc = 0.0;
#pragma unroll
            for (int b = 0; b < 2; ++b) {
#pragma unroll
                for (int a = 0; a < 2; ++a) {
                    double term = W[2 * b + a] *
                        __ldg(g_img + 4 * ((size_t)(iy + b) * Gx + ix + a) + c);
                    acc = (b == 0 && a == 0) ? term : acc + term;
                }
            }
            ge[c] = acc;
        }
        if (inside) {
#pragma unroll
            for (int c = 0; c < 4; ++c) gc[c] = ge[c];
        }
        const bool win = t <= vl;
        // gu = grad_u, components [g00, g01, g10, g11]; (grad_u^T d)_1 =
        // g00 d1 + g10 d2, (grad_u^T d)_2 = g01 d1 + g11 d2
        double g00 = win ? gc[0] : 0.0, g01 = win ? gc[1] : 0.0;
        double g10 = win ? gc[2] : 0.0, g11 = win ? gc[3] : 0.0;
        double d1 = rk[2 * t] - mu1;
        double d2 = rk[2 * t + 1] - mu2;
        double m1 = mu1 - h * (g00 * d1 + g10 * d2);
        double m2 = mu2 - h * (g01 * d1 + g11 * d2);
        mk[2 * kc] = m1;
        mk[2 * kc + 1] = m2;
        mu1 = m1;
        mu2 = m2;
    }
}

extern "C" int adjoint_ode_launch(const double* g_img, const double* x,
                                  const double* resid, const int* vlimit,
                                  double* mu, int K, int nt, int Gx, Geom g,
                                  double h, void* stream) {
    if (K <= 0) return 0;
    const int threads = 64;
    int blocks = (K + threads - 1) / threads;
    adjoint_ode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        g_img, x, resid, vlimit, mu, K, nt, Gx, g, h);
    return (int)cudaGetLastError();
}
