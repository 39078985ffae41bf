// Primal buoy ODE: all nt-1 explicit-Euler steps of every buoy in one
// launch.
//
// Replaces the Pallas TPU kernel ocean_jax/ode/pallas_ode.py::_make_kernel
// (launched by _run_pallas_ode). It computes what that kernel computes,
// in native float64 instead of double-single f32 pairs and with a direct
// gather instead of the one-hot MXU row selection: one thread per buoy
// walks its time loop; each step tests the (boundary-inclusive) domain,
// locates the clamped position on the half-grid, weights the 3x3 P2
// patch of the velocity image, and takes x <- x + h u(x). A buoy that
// leaves the domain freezes, records u = 0 from then on, and keeps the
// step kfail of its first failure. The last-step evaluation, the
// recentring and the overwrite of escaped buoys stay with the caller
// (ocean_torch/ode/cuda_ode.py), as in the JAX package.
//
// Bound on the card: a buoy's 199 steps are a dependent chain (each
// step's gather address comes from the previous step's position), so the
// kernel is latency-bound; the bytes it must move (x0 in, x and u out:
// K*nt*2*8 B each) take ~10 us at 3.35 TB/s. The velocity image
// (65*65*2*8 B = 68 KB at Nx=32) stays hot in L1/L2 and is read through
// the read-only path. Outputs are buoy-major (K, nt, 2), the layout the
// rest of the port uses; each thread writes 16 B per step.
//
// Built with --fmad=false (see grid.cuh): failed/kfail must match the
// plain version exactly.

#include "grid.cuh"

__global__ void primal_ode_kernel(const double* __restrict__ u_img,
                                  const double* __restrict__ x0,
                                  double* __restrict__ xs,
                                  double* __restrict__ us,
                                  int* __restrict__ failed_out,
                                  int* __restrict__ kfail_out, int K, int nt,
                                  int Hx, Geom g, double h) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    double* xk = xs + (size_t)k * nt * 2;
    double* uk = us + (size_t)k * nt * 2;
    double px = x0[2 * k], py = x0[2 * k + 1];
    xk[0] = px;
    xk[1] = py;
    uk[2 * (nt - 1)] = 0.0;
    uk[2 * (nt - 1) + 1] = 0.0;
    bool failed = false;
    int kfail = nt;
    for (int kc = 0; kc < nt - 1; ++kc) {
        bool inside = in_domain(g, px, py);
        int ix, iy;
        double s, t;
        locate(g, px, py, ix, iy, s, t);
        double W[9];
        p2_weights(s, t, W);
        const double* base = u_img + 2 * ((size_t)(2 * iy) * Hx + 2 * ix);
        double ux = 0.0, uy = 0.0;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const double* node = base + 2 * (b * Hx + a);
                double tx = W[3 * b + a] * __ldg(node);
                double ty = W[3 * b + a] * __ldg(node + 1);
                if (b == 0 && a == 0) {
                    ux = tx;
                    uy = ty;
                } else {
                    ux = ux + tx;
                    uy = uy + ty;
                }
            }
        }
        bool fail_now = !inside && !failed;
        failed = failed || !inside;
        if (fail_now) kfail = kc;
        double nx = failed ? px : px + h * ux;
        double ny = failed ? py : py + h * uy;
        uk[2 * kc] = failed ? 0.0 : ux;
        uk[2 * kc + 1] = failed ? 0.0 : uy;
        xk[2 * (kc + 1)] = nx;
        xk[2 * (kc + 1) + 1] = ny;
        px = nx;
        py = ny;
    }
    failed_out[k] = failed ? 1 : 0;
    kfail_out[k] = kfail;
}

extern "C" int primal_ode_launch(const double* u_img, const double* x0,
                                 double* xs, double* us, int* failed,
                                 int* kfail, int K, int nt, int Hx, Geom g,
                                 double h, void* stream) {
    if (K <= 0) return 0;
    const int threads = 64;
    int blocks = (K + threads - 1) / threads;
    primal_ode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        u_img, x0, xs, us, failed, kfail, K, nt, Hx, g, h);
    return (int)cudaGetLastError();
}
