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
// kernel does. Escaped buoys are masked to mu = 0 by the caller. With the
// obstacle, a point in the disk or in a removed square is outside (the
// located square is tested after locate): the carry engages there too.
// Native float64 replaces the TPU's double-single pairs and one-hot MXU
// row selection.
//
// Bound on the card: the bytes. x and u - u_d come in and mu goes out,
// K*nt*2*8 B each (96 MB at K=1e4, nt=200: ~29 us at 3.35 TB/s). Only two
// things are sequential in time: the carry of the last in-domain grad_u
// and the 2x2 affine mu update, about five dependent float64 operations
// a step. Everything before them depends on x alone. So a block owns
// kTile buoys and walks their time axis from the end in chunks of kChunk
// steps, each chunk in two phases:
//
//  * gather, all threads, one point each with time along the lanes: in
//    the buoy-major (K, nt, 2) layout the consecutive steps of a buoy are
//    contiguous, so a warp reads 512 contiguous bytes of x and of u - u_d
//    as 16-byte loads. Each point is located and its 2x2 patch weighted as
//    p1_eval.cu does (same helpers, same order of additions); grad_u, the
//    inside flag and the residual go to shared memory, never to device
//    memory;
//  * chain, one lane per buoy: carry, window and mu update from shared
//    memory, in the plain version's operation order. mu[t-1] overwrites
//    the residual of t in place and is written out with time along the
//    lanes by the thread that fills the same slot for the next chunk.
//
// A tile of 8 buoys by 16 steps is one point a thread and 6.7 KB of
// shared memory a block: K = 1e4 gives 1,250 blocks, nine or ten on an SM
// at once, so one block's chain runs while others gather (larger tiles
// and longer chunks measured slower). Rows of a buoy in shared memory
// have an odd stride in 16-byte units: the chain's lanes (one row each)
// and the gather's lanes (one slot each) both reach distinct banks.
//
// Built with --fmad=false (see grid.cuh): mu is bit-identical to the
// plain version.

#include "grid.cuh"

// ocean_torch/ode/cuda_adjoint.py holds the same two numbers (TILE,
// CHUNK) for the plain staged mirror of this kernel.
constexpr int kTile = 8;       // buoys of a block
constexpr int kChunk = 16;     // time steps of a chunk
constexpr int kThreads = 128;
constexpr int kStride = kChunk | 1;   // odd row stride, in slots
constexpr int kSlots = kTile * kStride;
static_assert(kTile <= kThreads, "one chain lane per buoy of the tile");

// G: the geometry type, the domain of in_domain and locate (grid.cuh)
template <class G>
__global__ void __launch_bounds__(kThreads)
adjoint_ode_kernel(const double* __restrict__ g_img,
                   const double2* __restrict__ x,
                   const double2* __restrict__ resid,
                   const int* __restrict__ vlimit, double2* __restrict__ mu,
                   int K, int nt, int Gx, G g, double h) {
    __shared__ double2 sA[kSlots];         // (g00, g01) of each slot
    __shared__ double2 sB[kSlots];         // (g10, g11)
    __shared__ double2 sR[kSlots];         // (u - u_d)[t], then mu[t-1]
    __shared__ unsigned char sF[kSlots];   // inside flag

    if constexpr (G::kGraded) {
        extern __shared__ double lines[];    // the grid lines, dynamic
        stage_lines(g, lines);
    }

    const int tid = threadIdx.x;
    const int k0 = blockIdx.x * kTile;
    const int nb = min(kTile, K - k0);     // buoys of this block
    const int nchunks = (nt - 1 + kChunk - 1) / kChunk;

    // state of the chain lanes (tid < nb), carried across the chunks
    double mu1 = 0.0, mu2 = 0.0;
    double g00 = 0.0, g01 = 0.0, g10 = 0.0, g11 = 0.0;
    int vl = 0;
    if (tid < nb) {
        vl = vlimit[k0 + tid];
        mu[(size_t)(k0 + tid) * nt + nt - 1] = make_double2(0.0, 0.0);
    }

    for (int c = 0; c <= nchunks; ++c) {
        // slot j of a row holds time t_base + j; times below 1 (the ragged
        // last chunk) stay empty
        const int t_base = nt - (c + 1) * kChunk;
        for (int idx = tid; idx < kTile * kChunk; idx += kThreads) {
            const int b = idx / kChunk, j = idx - b * kChunk;
            if (b >= nb) break;
            const int slot = b * kStride + j;
            const size_t row = (size_t)(k0 + b) * nt;
            if (c > 0) {             // mu of the chunk before, from t_prev
                const int t_prev = t_base + kChunk + j;
                if (t_prev >= 1) mu[row + t_prev - 1] = sR[slot];
            }
            const int t = t_base + j;
            if (c < nchunks && t >= 1) {
                const double2 p = x[row + t];
                sR[slot] = resid[row + t];
                const bool inside = in_domain(g, p.x, p.y);
                if constexpr (!G::kHole) sF[slot] = inside;
                int ix, iy;
                double s, tl;
                locate(g, p.x, p.y, ix, iy, s, tl);
                if constexpr (G::kHole)
                    sF[slot] = inside && off_obstacle(g, p.x, p.y, ix, iy);
                double W[4];
                p1_weights<G::kLeft>(s, tl, W);
                double ge[4];
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    double acc = 0.0;
#pragma unroll
                    for (int bb = 0; bb < 2; ++bb) {
#pragma unroll
                        for (int a = 0; a < 2; ++a) {
                            double term = W[2 * bb + a] * __ldg(
                                g_img + 4 * ((size_t)(iy + bb) * Gx + ix + a)
                                + cc);
                            acc = (bb == 0 && a == 0) ? term : acc + term;
                        }
                    }
                    ge[cc] = acc;
                }
                sA[slot] = make_double2(ge[0], ge[1]);
                sB[slot] = make_double2(ge[2], ge[3]);
            }
        }
        if (c == nchunks) break;
        __syncthreads();
        if (tid < nb) {
            const int j_lo = t_base >= 1 ? 0 : 1 - t_base;
#pragma unroll 4
            for (int j = kChunk - 1; j >= j_lo; --j) {
                const int slot = tid * kStride + j;
                const double2 a = sA[slot], bq = sB[slot], r = sR[slot];
                if (sF[slot]) {
                    g00 = a.x;
                    g01 = a.y;
                    g10 = bq.x;
                    g11 = bq.y;
                }
                const bool win = t_base + j <= vl;
                // grad_u components [g00, g01, g10, g11]; (grad_u^T d)_1 =
                // g00 d1 + g10 d2, (grad_u^T d)_2 = g01 d1 + g11 d2
                const double w00 = win ? g00 : 0.0, w01 = win ? g01 : 0.0;
                const double w10 = win ? g10 : 0.0, w11 = win ? g11 : 0.0;
                const double d1 = r.x - mu1;
                const double d2 = r.y - mu2;
                const double m1 = mu1 - h * (w00 * d1 + w10 * d2);
                const double m2 = mu2 - h * (w01 * d1 + w11 * d2);
                sR[slot] = make_double2(m1, m2);
                mu1 = m1;
                mu2 = m2;
            }
        }
        __syncthreads();
    }
}

extern "C" int adjoint_ode_launch(const double* g_img, const double* x,
                                  const double* resid, const int* vlimit,
                                  double* mu, int K, int nt, int Gx, Geom g,
                                  double h, void* stream) {
    if (K <= 0) return 0;
    int blocks = (K + kTile - 1) / kTile;
    return with_geom(g, [&](auto geom) {
        adjoint_ode_kernel<<<blocks, kThreads, lines_bytes(geom),
                             (cudaStream_t)stream>>>(
            g_img, (const double2*)x, (const double2*)resid, vlimit,
            (double2*)mu, K, nt, Gx, geom, h);
        return (int)cudaGetLastError();
    });
}
