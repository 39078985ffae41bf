// Shared device helpers of the grid kernels: point location on the
// structured grid of a rectangle, of the L-shape (a rectangle less its
// upper-left block) or of the gen-1 pipe (a rectangle, its grid uniform or
// graded, with or without the squares around its circular obstacle), the
// inside-domain test, and the closed-form P2/P1 patch weights of
// ocean_torch/ode/grideval.py for either diagonal.
//
// The domain is a template parameter of in_domain, locate, locate_short
// and of every kernel: the geometry type G. RectGeom and LshapeGeom are
// the uniform rectangle and L-shape with the "right" diagonal;
// LeftDiag<G> is G with the "left" one; PipeGeom<kGraded, kHole> is a
// rectangle located by its grid lines (kGraded) and/or with an obstacle
// (kHole). A uniform pipe without an obstacle is a RectGeom. Each type
// carries its properties as compile-time constants (kLshape, kLeft,
// kGraded, kHole). A launch function gets the whole host description
// Geom and hands the kernel the geometry in its own type (with_geom). The
// rectangle's and the L-shape's right-diagonal kernels take the structs
// they took before the other domains came and hold no trace of them.
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

// Geometry constants of a uniform rectangle grid.
struct RectGeom {
    static constexpr bool kLshape = false, kLeft = false;
    static constexpr bool kGraded = false, kHole = false;
    double ox, oy;              // origin
    double hx, hy;              // spacing
    double inv_hx, inv_hy;      // 1/spacing where that is exact, else 0
    double xmin, ymin, xmax, ymax;           // extent (clamp box)
    double xmin_e, ymin_e, xmax_e, ymax_e;   // extent -/+ 1e-12 slack
    int nx, ny;                 // squares per axis
};

// The L-shape: a uniform grid over the bounding box, less the upper-left
// block.
struct LshapeGeom {
    static constexpr bool kLshape = true, kLeft = false;
    static constexpr bool kGraded = false, kHole = false;
    double ox, oy, hx, hy, inv_hx, inv_hy;
    double xmin, ymin, xmax, ymax;
    double xmin_e, ymin_e, xmax_e, ymax_e;
    int nx, ny;
    int lshape;                 // 1
    // inner corner, its slack thresholds cx - 1e-12 and cy + 1e-12, and
    // the height cy - hy/2 that points of the missing block (x < cx,
    // y > cy) are located at
    double cx, cy, cx_e, cy_e, y_proj;
};

// The pipe: a rectangle whose grid is located by its lines (kGraded; the
// uniform fields hx, hy, inv_hx, inv_hy are then not read) and/or with an
// obstacle (kHole): the disk of centre (hcx, hcy) and radius sqrt(r2),
// whose squares are inactive in the (ny, nx) table `active`.
template <bool kGradedT, bool kHoleT>
struct PipeGeom {
    static constexpr bool kLshape = false, kLeft = false;
    static constexpr bool kGraded = kGradedT, kHole = kHoleT;
    double ox, oy, hx, hy, inv_hx, inv_hy;
    double xmin, ymin, xmax, ymax;
    double xmin_e, ymin_e, xmax_e, ymax_e;
    int nx, ny;
    double hcx, hcy, r2;
    const double* xs;           // nx + 1 grid lines (kGraded)
    const double* ys;           // ny + 1
    const unsigned char* active;   // 1 where a square holds cells (kHole)
};

// G with the "left" diagonal (v10 -- v01) instead of the "right" one.
template <class B>
struct LeftDiag : B {
    static constexpr bool kLeft = true;
};

// What the launch functions are handed; the ctypes mirror is
// ocean_torch/kernels.py::Geom (same field order).
struct Geom {
    double ox, oy, hx, hy, inv_hx, inv_hy;
    double xmin, ymin, xmax, ymax;
    double xmin_e, ymin_e, xmax_e, ymax_e;
    int nx, ny;
    int lshape;
    double cx, cy, cx_e, cy_e, y_proj;
    int left, graded, hole;
    double hcx, hcy, r2;
    const double* xs;
    const double* ys;
    const unsigned char* active;
};

// the fields every geometry type has
template <class T>
static inline T grid_of(const Geom& a) {
    T r{};
    r.ox = a.ox; r.oy = a.oy; r.hx = a.hx; r.hy = a.hy;
    r.inv_hx = a.inv_hx; r.inv_hy = a.inv_hy;
    r.xmin = a.xmin; r.ymin = a.ymin; r.xmax = a.xmax; r.ymax = a.ymax;
    r.xmin_e = a.xmin_e; r.ymin_e = a.ymin_e;
    r.xmax_e = a.xmax_e; r.ymax_e = a.ymax_e;
    r.nx = a.nx; r.ny = a.ny;
    return r;
}

template <class Fn, class T>
static inline int with_diagonal(const Geom& a, Fn fn, const T& g) {
    return a.left ? fn(LeftDiag<T>{g}) : fn(g);
}

template <class T>
static inline T pipe_of(const Geom& a) {
    T p = grid_of<T>(a);
    p.hcx = a.hcx; p.hcy = a.hcy; p.r2 = a.r2;
    p.xs = a.xs; p.ys = a.ys; p.active = a.active;
    return p;
}

// Calls fn(g) with g the geometry of a's domain in its own type.
template <class Fn>
static inline int with_geom(const Geom& a, Fn fn) {
    if (a.lshape) {
        LshapeGeom l = grid_of<LshapeGeom>(a);
        l.lshape = 1;
        l.cx = a.cx; l.cy = a.cy; l.cx_e = a.cx_e; l.cy_e = a.cy_e;
        l.y_proj = a.y_proj;
        return with_diagonal(a, fn, l);
    }
    if (a.graded && a.hole)
        return with_diagonal(a, fn, pipe_of<PipeGeom<true, true>>(a));
    if (a.graded)
        return with_diagonal(a, fn, pipe_of<PipeGeom<true, false>>(a));
    if (a.hole)
        return with_diagonal(a, fn, pipe_of<PipeGeom<false, true>>(a));
    return with_diagonal(a, fn, grid_of<RectGeom>(a));
}

// mesh/locate.py::in_domain (boundary inclusive), without the obstacle
template <class G>
__device__ __forceinline__ bool in_domain(const G& g, double x, double y) {
    if constexpr (G::kLshape) {
        return (x >= g.xmin_e) && (x <= g.xmax_e) && (y >= g.ymin_e) &&
               (y <= g.ymax_e) && ((y <= g.cy_e) || (x >= g.cx_e));
    } else {
        return (x >= g.xmin_e) && (x <= g.xmax_e) && (y >= g.ymin_e) &&
               (y <= g.ymax_e);
    }
}

// the obstacle's part of mesh/locate.py::in_domain: the raw position off
// the disk, (x - hcx)^2 + (y - hcy)^2 >= r^2 (torch's ** 2 is the product
// d * d), and the square (ix, iy) located from the clamped position
// holding cells (kernels.py::off_obstacle is the plain mirror). True
// without an obstacle.
template <class G>
__device__ __forceinline__ bool off_obstacle(const G& g, double x, double y,
                                             int ix, int iy) {
    if constexpr (G::kHole) {
        const double dx = x - g.hcx, dy = y - g.hcy;
        return (dx * dx + dy * dy >= g.r2) &&
               __ldg(g.active + (size_t)iy * g.nx + ix) != 0;
    } else {
        return true;
    }
}

// Copies the grid lines of a graded geometry into shared memory `lines`
// (nx + 1 + ny + 1 doubles) and points g at them; every thread of the
// block calls it. A no-op on a uniform grid.
template <class G>
__device__ __forceinline__ void stage_lines(G& g, double* lines) {
    if constexpr (G::kGraded) {
        for (int i = threadIdx.x; i <= g.nx; i += blockDim.x)
            lines[i] = g.xs[i];
        for (int i = threadIdx.x; i <= g.ny; i += blockDim.x)
            lines[g.nx + 1 + i] = g.ys[i];
        __syncthreads();
        g.xs = lines;
        g.ys = lines + g.nx + 1;
    }
}

// shared-memory bytes of stage_lines
template <class G>
static inline size_t lines_bytes(const G& g) {
    return G::kGraded ? (size_t)(g.nx + 1 + g.ny + 1) * sizeof(double) : 0;
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

// mesh/locate.py::_square_index on a graded grid, one axis: the owning
// square of a clamped position p among the n + 1 sorted lines is
// #{lines <= p} - 1 clamped to [0, n-1], counted by a binary search, and
// its local coordinate is (p - l[i]) / (l[i+1] - l[i]) (subtract, subtract,
// one division). A line counts where !(line > p), as
// torch.searchsorted(right=True) counts: a NaN counts every line and lands
// in the last square, as there (kernels.py::graded_axis is the plain
// mirror).
__device__ __forceinline__ void axis_search(double p, const double* lines,
                                            int n, int& i, double& s) {
    int lo = 0, hi = n + 1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!(lines[mid] > p))
            lo = mid + 1;
        else
            hi = mid;
    }
    i = max(0, min(lo - 1, n - 1));
    const double l0 = lines[i];
    s = (p - l0) / (lines[i + 1] - l0);
}

// clamp (+ project, mesh/locate.py::clamp_to_extent) + locate: square
// (ix, iy) and local (s, t) of a raw position
template <class G>
__device__ __forceinline__ void locate(const G& g, double px, double py,
                                       int& ix, int& iy, double& s,
                                       double& t) {
    double qx = clampd(px, g.xmin, g.xmax);
    double qy = clampd(py, g.ymin, g.ymax);
    if constexpr (G::kLshape)
        qy = ((qx < g.cx) && (qy > g.cy)) ? g.y_proj : qy;
    if constexpr (G::kGraded) {
        axis_search(qx, g.xs, g.nx, ix, s);
        axis_search(qy, g.ys, g.ny, iy, t);
    } else {
        axis_split(axis_f(qx, g.ox, g.hx, g.inv_hx), g.nx, ix, s);
        axis_split(axis_f(qy, g.oy, g.hy, g.inv_hy), g.ny, iy, t);
    }
}

// The same location with the shortest chain of dependent operations, for
// a kernel whose time is that chain (the primal ODE: each step's position
// comes from the step before). The clamp moves from the position to the
// coordinate: a clamped position is exactly p, lo or hi, and f is a
// function of it, so choosing between f(p), f(lo) and f(hi) gives the same
// bits while the compares run beside the subtraction and the product
// instead of before them. f(lo) and f(hi) do not depend on the point:
// AxisEnds holds them, computed once before the time loop.
//
// On the L-shape a point of the missing block is moved to y_proj, a third
// constant, so its coordinate is f(y_proj), held beside the two ends. The
// plain version tests the block on the clamped position, clamp(px) < cx
// and clamp(py) > cy; since xmin < cx <= xmax and ymin <= cy < ymax
// (kernels.py::geom checks) the raw position answers alike, NaN included,
// and the test runs beside the arithmetic as the clamps do
// (kernels.py::lshape_fy_short is the plain mirror).
struct AxisEnds {
    double fx_lo, fx_hi, fy_lo, fy_hi;
    double fy_proj;             // L-shape only
};

template <class G>
__device__ __forceinline__ AxisEnds axis_ends(const G& g) {
    if constexpr (G::kGraded) return AxisEnds{};     // not read
    AxisEnds e;
    e.fx_lo = axis_f(g.xmin, g.ox, g.hx, g.inv_hx);
    e.fx_hi = axis_f(g.xmax, g.ox, g.hx, g.inv_hx);
    e.fy_lo = axis_f(g.ymin, g.oy, g.hy, g.inv_hy);
    e.fy_hi = axis_f(g.ymax, g.oy, g.hy, g.inv_hy);
    if constexpr (G::kLshape)
        e.fy_proj = axis_f(g.y_proj, g.oy, g.hy, g.inv_hy);
    return e;
}

// (not for a graded grid, whose coordinate is no f = (p - o) / h: it is
// located by locate)
//
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

template <class G>
__device__ __forceinline__ void locate_short(const G& g, const AxisEnds& e,
                                             double px, double py, int& ix,
                                             int& iy, double& s, double& t) {
    axis_split(axis_f_clamped(px, g.xmin, g.xmax, e.fx_lo, e.fx_hi, g.ox,
                              g.hx, g.inv_hx), g.nx, ix, s);
    if constexpr (G::kLshape) {
        double fy = axis_f_clamped(py, g.ymin, g.ymax, e.fy_lo, e.fy_hi,
                                   g.oy, g.hy, g.inv_hy);
        fy = ((px < g.cx) && (py > g.cy)) ? e.fy_proj : fy;
        axis_split(fy, g.ny, iy, t);
    } else {
        axis_split(axis_f_clamped(py, g.ymin, g.ymax, e.fy_lo, e.fy_hi, g.oy,
                                  g.hy, g.inv_hy), g.ny, iy, t);
    }
}

__device__ __forceinline__ double vert(double l) { return l * (2.0 * l - 1.0); }

// ode/grideval.py::upper_triangle: the square's second triangle, above
// the diagonal v00 -- v11 ("right") or v10 -- v01 ("left")
template <bool kLeft>
__device__ __forceinline__ bool upper(double s, double t) {
    return kLeft ? (s + t > 1.0) : (t > s);
}

// ode/grideval.py::p2_patch_weights: W[3*b + a] multiplies half-grid
// node (2*iy + b, 2*ix + a)
template <bool kLeft = false>
__device__ __forceinline__ void p2_weights(double s, double t, double* W) {
    if constexpr (kLeft) {
        if (upper<true>(s, t)) {
            double lB = 1.0 - t, lC = s + t - 1.0, lD = 1.0 - s;
            W[0] = 0.0;             W[1] = 0.0;             W[2] = vert(lB);
            W[3] = 0.0;             W[4] = 4.0 * lB * lD;   W[5] = 4.0 * lB * lC;
            W[6] = vert(lD);        W[7] = 4.0 * lC * lD;   W[8] = vert(lC);
        } else {
            double lA = 1.0 - s - t, lB = s, lD = t;
            W[0] = vert(lA);        W[1] = 4.0 * lA * lB;   W[2] = vert(lB);
            W[3] = 4.0 * lA * lD;   W[4] = 4.0 * lB * lD;   W[5] = 0.0;
            W[6] = vert(lD);        W[7] = 0.0;             W[8] = 0.0;
        }
        return;
    }
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
template <bool kLeft = false>
__device__ __forceinline__ void p1_weights(double s, double t, double* W) {
    if constexpr (kLeft) {
        if (upper<true>(s, t)) {
            W[0] = 0.0;      W[1] = 1.0 - t;
            W[2] = 1.0 - s;  W[3] = s + t - 1.0;
        } else {
            W[0] = 1.0 - s - t;  W[1] = s;
            W[2] = t;            W[3] = 0.0;
        }
        return;
    }
    if (t > s) {
        W[0] = 1.0 - t;  W[1] = 0.0;
        W[2] = t - s;    W[3] = s;
    } else {
        W[0] = 1.0 - s;  W[1] = s - t;
        W[2] = 0.0;      W[3] = t;
    }
}
