// Primal buoy ODE on the locate/dofmap tables: all nt-1 explicit-Euler
// steps of every buoy in one launch.
//
// Replaces no TPU kernel: the JAX package runs this path (the "gather"
// backend, ocean_jax/ode/primal.py) as one lax.scan on the device, which
// the port's host loop (ocean_torch/ode/primal.py::euler_steps, ~70 small
// aten ops a step) had turned into 199 host-dispatched steps a solve. It
// computes what that loop computes with eval_velocity
// (ocean_torch/fem/interpolate.py) as its field: one thread per buoy walks
// its time loop; each step tests the (boundary-inclusive) domain, clamps
// and locates the position on the structured grid, reads the owning cell
// from square_to_cell, maps the clamped position to reference coordinates
// xi = J^-1 (p - v0) of that cell, weights the cell's six P2 dofs of u by
// the P2 basis at xi, and takes x <- x + h u(x). A buoy that leaves the
// domain freezes, records u = 0 from then on, and keeps the step kfail of
// its first failure. The last-step evaluation, the recentring and the
// overwrite of escaped buoys stay with the caller
// (ocean_torch/ode/cuda_table_ode.py), as after the grid kernel.
//
// Bound on the card: the chain. Each step's position comes from the step
// before, and a step is three dependent loads (the square's cell; that
// cell's v0, J^-1 and dofs; u at those dofs) with the location and the
// basis between them. At K = 3 buoys that chain is the whole time; the
// bytes (K*nt*2*16 B out) are nothing. So: one thread a buoy, one warp a
// block (a block of 32 at K = 3, 313 blocks spread over the SMs at K = 1e4),
// the tables and u read through the read-only path, no shared-memory
// staging of u; a graded grid's lines, which its binary search reads
// log2(n) times a step, go to shared memory.
//
// The domain is the template parameter G of grid.cuh (rectangle, L-shape,
// either diagonal; the pipe, graded and/or with its obstacle), chosen by
// with_geom. Location and the inside test are grid.cuh's (in_domain,
// locate, off_obstacle), which the grid kernels share. Built with
// --fmad=false (see grid.cuh), every double operation in the order of
// ode/cuda_table_ode.py::table_ode_steps_plain: x, u, failed and kfail are
// bit-identical to it.

#include "grid.cuh"

constexpr int kThreads = 32;         // buoys of a block: one warp

// u(px, py) from the tables: the clamped (and, on the L-shape, projected)
// position as mesh/locate.py::clamp_to_extent gives it, its owning cell,
// the reference coordinates and the six-term P2 sum of
// fem/interpolate.py::eval_velocity, each sum written out in order;
// (ix, iy) is the owning square, which the obstacle test reads
template <class G>
__device__ __forceinline__ void table_velocity(
    const long long* __restrict__ square_to_cell,
    const double2* __restrict__ cell_v0,
    const double2* __restrict__ cell_jinv,
    const long long* __restrict__ cell_dofs,
    const double2* __restrict__ u, const G& g, double px, double py,
    double& ux, double& uy, int& ix, int& iy) {
    double s, t;
    locate(g, px, py, ix, iy, s, t);
    const double qx = clampd(px, g.xmin, g.xmax);
    double qy = clampd(py, g.ymin, g.ymax);
    if constexpr (G::kLshape)
        qy = ((qx < g.cx) && (qy > g.cy)) ? g.y_proj : qy;
    const int which = upper<G::kLeft>(s, t) ? 1 : 0;
    long long cell = __ldg(square_to_cell +
                           ((size_t)iy * g.nx + ix) * 2 + which);
    cell = cell < 0 ? 0 : cell;
    const double2 v0 = __ldg(cell_v0 + cell);
    const double2 j0 = __ldg(cell_jinv + 2 * cell);       // row 0 of J^-1
    const double2 j1 = __ldg(cell_jinv + 2 * cell + 1);   // row 1
    long long dof[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) dof[a] = __ldg(cell_dofs + 6 * cell + a);
    const double d0 = qx - v0.x, d1 = qy - v0.y;
    const double xi = j0.x * d0 + j0.y * d1;
    const double eta = j1.x * d0 + j1.y * d1;
    const double l0 = 1.0 - xi - eta;
    const double phi[6] = {l0 * (2.0 * l0 - 1.0), xi * (2.0 * xi - 1.0),
                           eta * (2.0 * eta - 1.0), 4.0 * xi * eta,
                           4.0 * l0 * eta, 4.0 * l0 * xi};
#pragma unroll
    for (int a = 0; a < 6; ++a) {
        const double2 v = __ldg(u + dof[a]);
        const double tx = phi[a] * v.x, ty = phi[a] * v.y;
        ux = (a == 0) ? tx : ux + tx;
        uy = (a == 0) ? ty : uy + ty;
    }
}

template <class G>
__global__ void __launch_bounds__(kThreads)
table_euler_kernel(const long long* __restrict__ square_to_cell,
                   const double2* __restrict__ cell_v0,
                   const double2* __restrict__ cell_jinv,
                   const long long* __restrict__ cell_dofs,
                   const double2* __restrict__ u,
                   const double2* __restrict__ x0, double2* __restrict__ xs,
                   double2* __restrict__ us, int* __restrict__ failed_out,
                   int* __restrict__ kfail_out, int K, int nt, G g,
                   double h) {
    extern __shared__ double lines[];
    stage_lines(g, lines);
    const int k = blockIdx.x * kThreads + threadIdx.x;
    if (k >= K) return;
    const double2 start = x0[k];
    double px = start.x, py = start.y;
    double2* xk = xs + (size_t)k * nt;
    double2* uk = us + (size_t)k * nt;
    xk[0] = start;
    uk[nt - 1] = make_double2(0.0, 0.0);
    bool failed = false;
    int kfail = nt;
    for (int j = 0; j < nt - 1; ++j) {
        bool inside = in_domain(g, px, py);
        double ux, uy;
        int ix, iy;
        table_velocity(square_to_cell, cell_v0, cell_jinv, cell_dofs, u, g,
                       px, py, ux, uy, ix, iy);
        inside = inside && off_obstacle(g, px, py, ix, iy);
        if (!inside && !failed) kfail = j;
        failed = failed || !inside;
        px = failed ? px : px + h * ux;
        py = failed ? py : py + h * uy;
        uk[j] = make_double2(failed ? 0.0 : ux, failed ? 0.0 : uy);
        xk[j + 1] = make_double2(px, py);
    }
    failed_out[k] = failed ? 1 : 0;
    kfail_out[k] = kfail;
}

template <class G>
static int launch(const long long* square_to_cell, const double* cell_v0,
                  const double* cell_jinv, const long long* cell_dofs,
                  const double* u, const double* x0, double* xs, double* us,
                  int* failed, int* kfail, int K, int nt, G g, double h,
                  void* stream) {
    const int blocks = (K + kThreads - 1) / kThreads;
    table_euler_kernel<G><<<blocks, kThreads, lines_bytes(g),
                            (cudaStream_t)stream>>>(
        square_to_cell, (const double2*)cell_v0, (const double2*)cell_jinv,
        cell_dofs, (const double2*)u, (const double2*)x0, (double2*)xs,
        (double2*)us, failed, kfail, K, nt, g, h);
    return (int)cudaGetLastError();
}

extern "C" int table_ode_launch(const long long* square_to_cell,
                                const double* cell_v0,
                                const double* cell_jinv,
                                const long long* cell_dofs, const double* u,
                                const double* x0, double* xs, double* us,
                                int* failed, int* kfail, int K, int nt,
                                Geom g, double h, void* stream) {
    if (K <= 0) return 0;
    return with_geom(g, [&](auto geom) {
        return launch(square_to_cell, cell_v0, cell_jinv, cell_dofs, u, x0,
                      xs, us, failed, kfail, K, nt, geom, h, stream);
    });
}
