// P1 tensor (projected grad u) evaluation at arbitrary points.
//
// Replaces the Pallas TPU kernel
// ocean_jax/ode/pallas_eval.py::_make_eval_kernel (launched by _run_eval,
// wrapped by eval_p1_tensor_pallas). For each of N points: clamp and
// locate (on the L-shape: project; on a graded grid: search its lines,
// staged in shared memory) on the vertex grid, take the P1 weights of the
// 2x2 vertex patch (either diagonal), and sum the patch of each of the 4
// components of the (Gy*Gx, 2, 2) vertex image, row b then column a, in
// the order of ocean_torch/ode/grideval.py::eval_p1_tensor_grid. The
// float64 in_domain flag of each point is written beside its value, as
// the plain version returns it (with the obstacle's test of the located
// square). Native float64 replaces the TPU's double-single pairs, and a
// direct read of the image replaces its one-hot MXU row selection; there
// is no (8, 128) padding.
//
// Bound on the card: one thread per point, no loop. The bytes it must
// move are the points in (16 B) and the values out (32 B) plus the flag
// (1 B): ~98 MB at N = 2e6, ~29 us at 3.35 TB/s. Points are read and
// values written as 16-byte double2 accesses by neighbouring threads
// (coalesced). The image (35 KB at Nx=32) stays in L1/L2 and is read
// through the read-only path. About 45 float64 operations per point are
// far below the byte bound.
//
// Built with --fmad=false (see grid.cuh): kernel and plain version agree
// bit for bit.

#include "grid.cuh"

// G: the geometry type, the domain of in_domain and locate (grid.cuh)
template <class G>
__global__ void p1_eval_kernel(const double* __restrict__ g_img,
                               const double2* __restrict__ pts,
                               double2* __restrict__ vals,
                               bool* __restrict__ inside, long long N, int Gx,
                               G g) {
    if constexpr (G::kGraded) {
        extern __shared__ double lines[];    // the grid lines, dynamic
        stage_lines(g, lines);
    }
    for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         n < N; n += (long long)gridDim.x * blockDim.x) {
        const double2 p = pts[n];
        const bool in = in_domain(g, p.x, p.y);
        if constexpr (!G::kHole) inside[n] = in;
        int ix, iy;
        double s, t;
        locate(g, p.x, p.y, ix, iy, s, t);
        if constexpr (G::kHole)
            inside[n] = in && off_obstacle(g, p.x, p.y, ix, iy);
        double W[4];
        p1_weights<G::kLeft>(s, t, W);
        double out[4];
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
            out[c] = acc;
        }
        vals[2 * n] = make_double2(out[0], out[1]);
        vals[2 * n + 1] = make_double2(out[2], out[3]);
    }
}

extern "C" int p1_eval_launch(const double* g_img, const double* pts,
                              double* vals, bool* inside, long long N, int Gx,
                              Geom g, void* stream) {
    if (N <= 0) return 0;
    const int threads = 256;
    long long want = (N + threads - 1) / threads;
    int blocks = (int)(want < 65535 ? want : 65535);
    return with_geom(g, [&](auto geom) {
        p1_eval_kernel<<<blocks, threads, lines_bytes(geom),
                         (cudaStream_t)stream>>>(
            g_img, (const double2*)pts, (double2*)vals, inside, N, Gx, geom);
        return (int)cudaGetLastError();
    });
}
