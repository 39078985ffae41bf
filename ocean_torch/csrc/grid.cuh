// Shared device helpers of the grid kernels: point location on the
// uniform structured grid ("right" diagonal) and the closed-form P2/P1
// patch weights of ocean_torch/ode/grideval.py.
//
// Every expression is written in the order the plain PyTorch version
// evaluates it (ocean_torch/mesh/locate.py, ocean_torch/ode/grideval.py)
// and the sources are compiled with --fmad=false: no multiply-add is
// contracted into an FMA, so each double operation rounds exactly as
// PyTorch's elementwise kernels do and kernel and plain version agree
// bit for bit. That matters for the escape test: a buoy within roundoff
// of the boundary slack must leave at the same step in both.
#pragma once

#include <cuda_runtime.h>

// Geometry constants of a uniform rectangle grid; the ctypes mirror is
// ocean_torch/kernels.py::Geom (same field order).
struct Geom {
    double ox, oy;              // origin
    double hx, hy;              // spacing
    double inv_hx, inv_hy;      // 1/spacing where that is exact, else 0
    double xmin, ymin, xmax, ymax;           // extent (clamp box)
    double xmin_e, ymin_e, xmax_e, ymax_e;   // extent -/+ 1e-12 slack
    int nx, ny;                 // squares per axis
};

// mesh/locate.py::in_domain (boundary inclusive)
__device__ __forceinline__ bool in_domain(const Geom& g, double x, double y) {
    return (x >= g.xmin_e) && (x <= g.xmax_e) && (y >= g.ymin_e) &&
           (y <= g.ymax_e);
}

// torch.clamp(v, lo, hi): NaN propagates
__device__ __forceinline__ double clampd(double v, double lo, double hi) {
    double r = v < lo ? lo : v;
    return r > hi ? hi : r;
}

// mesh/locate.py::_square_index, one axis, first half: the coordinate
// f = (p - o) / hs in units of squares. A spacing that is a power of two
// has an exact reciprocal (inv != 0, set by kernels.py::geom), and
// (p - o) * inv is then the same real number rounded once as (p - o) / hs:
// the same bits without the division. Any other spacing is divided
// (inv == 0).
__device__ __forceinline__ double axis_f(double p, double o, double hs,
                                         double inv) {
    return (inv != 0.0) ? (p - o) * inv : (p - o) / hs;
}

// second half: owning square index floor(f) clamped to [0, n-1] and the
// local coordinate f - i. One conversion rounds down and saturates (NaN
// gives 0), then the clamp is on integers: the same index as
// clamp(int(floor(f)), 0, n-1) for every f.
__device__ __forceinline__ void axis_split(double f, int n, int& i,
                                           double& s) {
    i = max(0, min(__double2int_rd(f), n - 1));
    s = f - (double)i;
}

// clamp + locate: square (ix, iy) and local (s, t) of a raw position
__device__ __forceinline__ void locate(const Geom& g, double px, double py,
                                       int& ix, int& iy, double& s,
                                       double& t) {
    double cx = clampd(px, g.xmin, g.xmax);
    double cy = clampd(py, g.ymin, g.ymax);
    axis_split(axis_f(cx, g.ox, g.hx, g.inv_hx), g.nx, ix, s);
    axis_split(axis_f(cy, g.oy, g.hy, g.inv_hy), g.ny, iy, t);
}

// The same location with the shortest chain of dependent operations, for
// a kernel whose time is that chain (the primal ODE: each step's position
// comes from the step before). The clamp moves from the position to the
// coordinate: a clamped position is exactly p, lo or hi, and f is a
// function of it, so choosing between f(p), f(lo) and f(hi) gives the same
// bits while the compares run beside the subtraction and the product
// instead of before them. f(lo) and f(hi) do not depend on the point:
// AxisEnds holds them, computed once before the time loop.
struct AxisEnds {
    double fx_lo, fx_hi, fy_lo, fy_hi;
};

__device__ __forceinline__ AxisEnds axis_ends(const Geom& g) {
    AxisEnds e;
    e.fx_lo = axis_f(g.xmin, g.ox, g.hx, g.inv_hx);
    e.fx_hi = axis_f(g.xmax, g.ox, g.hx, g.inv_hx);
    e.fy_lo = axis_f(g.ymin, g.oy, g.hy, g.inv_hy);
    e.fy_hi = axis_f(g.ymax, g.oy, g.hy, g.inv_hy);
    return e;
}

// f of clampd(p, lo, hi) for lo <= hi (an extent): both compares are of p
// itself, since p < lo rules out p > hi
__device__ __forceinline__ double axis_f_clamped(double p, double lo,
                                                 double hi, double f_lo,
                                                 double f_hi, double o,
                                                 double hs, double inv) {
    double f = axis_f(p, o, hs, inv);
    f = (p < lo) ? f_lo : f;
    return (p > hi) ? f_hi : f;
}

__device__ __forceinline__ void locate_short(const Geom& g,
                                             const AxisEnds& e, double px,
                                             double py, int& ix, int& iy,
                                             double& s, double& t) {
    axis_split(axis_f_clamped(px, g.xmin, g.xmax, e.fx_lo, e.fx_hi, g.ox,
                              g.hx, g.inv_hx), g.nx, ix, s);
    axis_split(axis_f_clamped(py, g.ymin, g.ymax, e.fy_lo, e.fy_hi, g.oy,
                              g.hy, g.inv_hy), g.ny, iy, t);
}

__device__ __forceinline__ double vert(double l) { return l * (2.0 * l - 1.0); }

// ode/grideval.py::p2_patch_weights: W[3*b + a] multiplies half-grid
// node (2*iy + b, 2*ix + a)
__device__ __forceinline__ void p2_weights(double s, double t, double* W) {
    if (t > s) {
        double lA = 1.0 - t, lC = s, lD = t - s;
        W[0] = vert(lA);        W[1] = 0.0;             W[2] = 0.0;
        W[3] = 4.0 * lA * lD;   W[4] = 4.0 * lA * lC;   W[5] = 0.0;
        W[6] = vert(lD);        W[7] = 4.0 * lC * lD;   W[8] = vert(lC);
    } else {
        double lA = 1.0 - s, lB = s - t, lC = t;
        W[0] = vert(lA);        W[1] = 4.0 * lA * lB;   W[2] = vert(lB);
        W[3] = 0.0;             W[4] = 4.0 * lA * lC;   W[5] = 4.0 * lB * lC;
        W[6] = 0.0;             W[7] = 0.0;             W[8] = vert(lC);
    }
}

// ode/grideval.py::p1_patch_weights: W[2*b + a] multiplies vertex node
// (iy + b, ix + a)
__device__ __forceinline__ void p1_weights(double s, double t, double* W) {
    if (t > s) {
        W[0] = 1.0 - t;  W[1] = 0.0;
        W[2] = t - s;    W[3] = s;
    } else {
        W[0] = 1.0 - s;  W[1] = s - t;
        W[2] = 0.0;      W[3] = t;
    }
}
