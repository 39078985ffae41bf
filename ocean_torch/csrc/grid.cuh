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

// mesh/locate.py::_square_index, one axis: owning square index clamped to
// [0, n-1] and the local coordinate f - i
__device__ __forceinline__ void axis_coord(double p, double o, double hs,
                                           int n, int& i, double& s) {
    double f = (p - o) / hs;
    double fl = floor(f);
    i = (fl >= 0.0) ? (fl <= (double)(n - 1) ? (int)fl : n - 1) : 0;
    s = f - (double)i;
}

// clamp + locate: square (ix, iy) and local (s, t) of a raw position
__device__ __forceinline__ void locate(const Geom& g, double px, double py,
                                       int& ix, int& iy, double& s,
                                       double& t) {
    double cx = clampd(px, g.xmin, g.xmax);
    double cy = clampd(py, g.ymin, g.ymax);
    axis_coord(cx, g.ox, g.hx, g.nx, ix, s);
    axis_coord(cy, g.oy, g.hy, g.ny, iy, t);
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
