// Primal buoy ODE: all nt-1 explicit-Euler steps of every buoy in one
// launch.
//
// Replaces the Pallas TPU kernel ocean_jax/ode/pallas_ode.py::_make_kernel
// (launched by _run_pallas_ode). It computes what that kernel computes,
// in native float64 instead of double-single f32 pairs and with a direct
// gather instead of the one-hot MXU row selection: one thread per buoy
// walks its time loop; each step tests the (boundary-inclusive) domain,
// locates the clamped position on the half-grid, weights the P2 patch of
// the velocity image, and takes x <- x + h u(x). A buoy that leaves the
// domain freezes, records u = 0 from then on, and keeps the step kfail of
// its first failure. The last-step evaluation, the recentring and the
// overwrite of escaped buoys stay with the caller
// (ocean_torch/ode/cuda_ode.py), as in the JAX package.
//
// Bound on the card: the chain. A buoy's steps depend on each other (the
// gather address of a step comes from the position of the step before),
// K = 1e4 buoys are 313 warps for 528 warp schedulers, so nothing hides a
// latency and the time is (nt - 1) x the dependent operations of a step.
// The bytes (x0 in, x and u out: K*nt*2*8 B each, ~19 us at 3.35 TB/s) are
// out of reach. What the design does about the chain:
//
//  * location with the shortest chain (grid.cuh::locate_short): no
//    division for a power-of-two spacing, the clamp beside the coordinate
//    instead of before it, one rounding-down conversion instead of floor,
//    two compares and a conversion;
//  * the six nodes of the owning triangle instead of the nine of the
//    patch: the three others have weight 0 and add +-0, so five chained
//    additions a component are left of eight. With the barycentrics
//    (l0, l1, l2) = (1-s, s-t, t) below the diagonal and (1-t, t-s, s)
//    above, the six weights are the same expressions in both triangles
//    and two of them trade places: selects, no divergent branch
//    (ocean_torch/ode/cuda_ode.py::eval_velocity_six_nodes is the plain
//    mirror);
//  * the velocity image in shared memory (67,600 B at Nx=32), one
//    cooperative copy a block, read as one 16-byte load a node: the gather
//    leaves the L1/L2 path that the stores use. An image that does not fit
//    beside the staging rows (Nx >= 53) is read through the read-only
//    global path by the same code; primal_ode_launch chooses by size;
//  * staged stores: a thread writing its own 16 bytes a step at a stride
//    of nt*16 B costs 32 partial sectors an instruction. Each warp keeps
//    kSteps steps of its 32 buoys in shared memory and writes them out
//    with time along the lanes, kSteps*16 contiguous bytes a buoy
//    (cuda_ode.py::staged_store_index is the index arithmetic).
//
// The domain is a second template parameter beside the image's place, the
// geometry type G of grid.cuh (rectangle, L-shape, either diagonal; the
// pipe, graded and/or with its obstacle): twenty instantiations, chosen by
// primal_ode_launch. The rectangle's and the L-shape's with the "right"
// diagonal are the code they were before the other domains came (the
// `else` of the step). The others take velocity_at: the "left" diagonal
// has its own six nodes (the same weights, other barycentrics); a graded
// grid is located by a binary search over its lines in shared memory
// (locate: the clamp on the coordinate of locate_short rests on a uniform
// f = (p - o) / h); the obstacle's test reads the owning square. On the
// L-shape the image covers the bounding box (101 x 101 nodes, 163,216 B,
// at resolution 50: with the 52,224 B of staging rows just inside the
// limit); the nodes of the missing block, or of the removed squares
// around the obstacle, hold zeros and an in-domain point never reads one
// with a weight other than 0. The gmsh-default graded pipe (147 x 147
// nodes, 345,744 B) reads its image from device memory.
//
// Built with --fmad=false (see grid.cuh): x, u, failed and kfail are
// bit-identical to the plain version (a zero may differ in sign).

#include "grid.cuh"

// ocean_torch/ode/cuda_ode.py holds kSteps as STEPS for the plain mirror
// of the staged stores.
constexpr int kSteps = 16;           // steps staged before a flush
constexpr int kThreads = 96;         // buoys of a block
constexpr int kWarps = kThreads / 32;
constexpr int kRow = kSteps | 1;     // odd row stride, in 16-byte slots
constexpr int kStageSlots = kWarps * 2 * 32 * kRow;   // x and u of a block
constexpr size_t kStageBytes = kStageSlots * sizeof(double2);
constexpr size_t kSharedLimit = 227 * 1024;   // of a block on this card

static_assert(32 % kSteps == 0, "a store instruction holds whole runs");

// u(px, py) from the half-grid image: the six nodes of the owning triangle
// in the row-major order of the 3x3 patch
template <bool kSharedImage, class G>
__device__ __forceinline__ void velocity(const double2* __restrict__ img,
                                         int Hx, const G& g,
                                         const AxisEnds& ends, double px,
                                         double py, double& ux, double& uy) {
    int ix, iy;
    double s, t;
    locate_short(g, ends, px, py, ix, iy, s, t);
    const bool up = t > s;
    const double l0 = up ? 1.0 - t : 1.0 - s;
    const double l1 = up ? t - s : s - t;
    const double l2 = up ? s : t;
    const double v0 = vert(l0), v1 = vert(l1), v2 = vert(l2);
    const double e01 = 4.0 * l0 * l1, e02 = 4.0 * l0 * l2;
    const double e12 = 4.0 * l1 * l2;
    // below: (0,0) (0,1) (0,2) (1,1) (1,2) (2,2); above: (0,0) (1,0) (1,1)
    // (2,0) (2,1) (2,2)
    const double w[6] = {v0, e01, up ? e02 : v1, up ? v1 : e02, e12, v2};
    const int o[6] = {0, up ? Hx : 1, up ? Hx + 1 : 2,
                      up ? 2 * Hx : Hx + 1, up ? 2 * Hx + 1 : Hx + 2,
                      2 * Hx + 2};
    const double2* base = img + ((size_t)(2 * iy) * Hx + 2 * ix);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const double2 v = kSharedImage ? base[o[i]] : __ldg(base + o[i]);
        const double tx = w[i] * v.x, ty = w[i] * v.y;
        ux = (i == 0) ? tx : ux + tx;
        uy = (i == 0) ? ty : uy + ty;
    }
}

// velocity() on the other domains: either diagonal, located by the grid
// lines where they are graded; (ix, iy) is the owning square, which the
// obstacle test reads
template <bool kSharedImage, class G>
__device__ __forceinline__ void velocity_at(const double2* __restrict__ img,
                                            int Hx, const G& g,
                                            const AxisEnds& ends, double px,
                                            double py, double& ux,
                                            double& uy, int& ix, int& iy) {
    double s, t;
    if constexpr (G::kGraded)
        locate(g, px, py, ix, iy, s, t);
    else
        locate_short(g, ends, px, py, ix, iy, s, t);
    const bool up = upper<G::kLeft>(s, t);
    double l0, l1, l2;
    if constexpr (G::kLeft) {
        l0 = up ? 1.0 - t : 1.0 - s - t;
        l1 = up ? 1.0 - s : s;
        l2 = up ? s + t - 1.0 : t;
    } else {
        l0 = up ? 1.0 - t : 1.0 - s;
        l1 = up ? t - s : s - t;
        l2 = up ? s : t;
    }
    const double v0 = vert(l0), v1 = vert(l1), v2 = vert(l2);
    const double e01 = 4.0 * l0 * l1, e02 = 4.0 * l0 * l2;
    const double e12 = 4.0 * l1 * l2;
    const double w[6] = {v0, e01, up ? e02 : v1, up ? v1 : e02, e12, v2};
    // "right", below: (0,0) (0,1) (0,2) (1,1) (1,2) (2,2); above: (0,0)
    // (1,0) (1,1) (2,0) (2,1) (2,2). "left", below: (0,0) (0,1) (0,2) (1,0)
    // (1,1) (2,0); above: (0,2) (1,1) (1,2) (2,0) (2,1) (2,2)
    int o[6];
    if constexpr (G::kLeft) {
        const int lo[6] = {0, 1, 2, Hx, Hx + 1, 2 * Hx};
        const int hi[6] = {2, Hx + 1, Hx + 2, 2 * Hx, 2 * Hx + 1,
                           2 * Hx + 2};
#pragma unroll
        for (int i = 0; i < 6; ++i) o[i] = up ? hi[i] : lo[i];
    } else {
        const int r[6] = {0, up ? Hx : 1, up ? Hx + 1 : 2,
                          up ? 2 * Hx : Hx + 1, up ? 2 * Hx + 1 : Hx + 2,
                          2 * Hx + 2};
#pragma unroll
        for (int i = 0; i < 6; ++i) o[i] = r[i];
    }
    const double2* base = img + ((size_t)(2 * iy) * Hx + 2 * ix);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const double2 v = kSharedImage ? base[o[i]] : __ldg(base + o[i]);
        const double tx = w[i] * v.x, ty = w[i] * v.y;
        ux = (i == 0) ? tx : ux + tx;
        uy = (i == 0) ? ty : uy + ty;
    }
}

template <bool kSharedImage, class G>
__global__ void __launch_bounds__(kThreads)
primal_ode_kernel(const double2* __restrict__ u_img,
                  const double2* __restrict__ x0, double2* __restrict__ xs,
                  double2* __restrict__ us, int* __restrict__ failed_out,
                  int* __restrict__ kfail_out, int K, int nt, int Hx, int Hy,
                  G g, double h) {
    extern __shared__ double2 shared[];
    // staging rows of this warp: x and u of its 32 buoys, kSteps steps
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    double2* sx = shared + (2 * warp) * 32 * kRow;
    double2* su = sx + 32 * kRow;
    const double2* img = u_img;
    if (kSharedImage) {
        double2* simg = shared + kStageSlots;
        for (int i = threadIdx.x; i < Hx * Hy; i += kThreads)
            simg[i] = u_img[i];
        __syncthreads();
        img = simg;
    }
    // a graded grid's lines go behind the staging rows and the image
    if constexpr (G::kGraded)
        stage_lines(g, reinterpret_cast<double*>(
                           shared + kStageSlots +
                           (kSharedImage ? Hx * Hy : 0)));
    // lanes past the last buoy walk the last buoy's path and store nothing:
    // a warp flushes together
    const int k = blockIdx.x * kThreads + threadIdx.x;
    const bool live = k < K;
    const double2 start = x0[live ? k : K - 1];
    double px = start.x, py = start.y;
    if (live) {
        xs[(size_t)k * nt] = start;
        us[(size_t)k * nt + nt - 1] = make_double2(0.0, 0.0);
    }
    const AxisEnds ends = axis_ends(g);
    bool failed = false;
    int kfail = nt;
    const int k_warp = k - lane;            // first buoy of the warp
    const int j_out = lane % kSteps;        // this lane's step in a flush
    for (int c0 = 0; c0 < nt - 1; c0 += kSteps) {
        const int cn = min(kSteps, nt - 1 - c0);
        for (int j = 0; j < cn; ++j) {
          if constexpr (G::kLeft || G::kGraded || G::kHole) {
            // the step on the other domains: the obstacle test reads the
            // owning square
            bool inside = in_domain(g, px, py);
            double ux, uy;
            int ix, iy;
            velocity_at<kSharedImage>(img, Hx, g, ends, px, py, ux, uy, ix,
                                      iy);
            inside = inside && off_obstacle(g, px, py, ix, iy);
            if (!inside && !failed) kfail = c0 + j;
            failed = failed || !inside;
            const double nx = failed ? px : px + h * ux;
            const double ny = failed ? py : py + h * uy;
            su[lane * kRow + j] = make_double2(failed ? 0.0 : ux,
                                               failed ? 0.0 : uy);
            sx[lane * kRow + j] = make_double2(nx, ny);
            px = nx;
            py = ny;
          } else {
            // the rectangle and the L-shape with the "right" diagonal: this
            // branch is their code as it was before the other domains came
            // (scripts/compare_ode_kernels_torch.py holds their machine
            // code to it)
            const bool inside = in_domain(g, px, py);
            double ux, uy;
            velocity<kSharedImage>(img, Hx, g, ends, px, py, ux, uy);
            if (!inside && !failed) kfail = c0 + j;
            failed = failed || !inside;
            const double nx = failed ? px : px + h * ux;
            const double ny = failed ? py : py + h * uy;
            su[lane * kRow + j] = make_double2(failed ? 0.0 : ux,
                                               failed ? 0.0 : uy);
            sx[lane * kRow + j] = make_double2(nx, ny);
            px = nx;
            py = ny;
          }
        }
        __syncwarp();
        // time along the lanes: an instruction writes kSteps consecutive
        // steps of 32 / kSteps buoys
        for (int b = lane / kSteps; b < 32; b += 32 / kSteps) {
            if (k_warp + b < K && j_out < cn) {
                const size_t at = (size_t)(k_warp + b) * nt + c0 + j_out;
                us[at] = su[b * kRow + j_out];
                xs[at + 1] = sx[b * kRow + j_out];
            }
        }
        __syncwarp();
    }
    if (live) {
        failed_out[k] = failed ? 1 : 0;
        kfail_out[k] = kfail;
    }
}

template <class G>
static int launch(const double* u_img, const double* x0, double* xs,
                  double* us, int* failed, int* kfail, int K, int nt, int Hx,
                  G g, double h, void* stream) {
    const int Hy = 2 * g.ny + 1;
    const int blocks = (K + kThreads - 1) / kThreads;
    // the image goes to shared memory where it fits beside the staging
    // rows, else it is read from device memory
    const size_t stage = kStageBytes + lines_bytes(g);
    const size_t with_image = stage + (size_t)Hx * Hy * sizeof(double2);
    const bool shared_image = with_image <= kSharedLimit;
    const size_t bytes = shared_image ? with_image : stage;
    auto kernel = shared_image ? primal_ode_kernel<true, G>
                               : primal_ode_kernel<false, G>;
    if (bytes > 48 * 1024) {         // has to be asked for above 48 KB
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        (const double2*)u_img, (const double2*)x0, (double2*)xs,
        (double2*)us, failed, kfail, K, nt, Hx, Hy, g, h);
    return (int)cudaGetLastError();
}

extern "C" int primal_ode_launch(const double* u_img, const double* x0,
                                 double* xs, double* us, int* failed,
                                 int* kfail, int K, int nt, int Hx, Geom g,
                                 double h, void* stream) {
    if (K <= 0) return 0;
    return with_geom(g, [&](auto geom) {
        return launch(u_img, x0, xs, us, failed, kfail, K, nt, Hx, geom, h,
                      stream);
    });
}
