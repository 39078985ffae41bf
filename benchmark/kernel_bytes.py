"""The least bytes each CUDA kernel of the buoy path has to move: every
input read once and every output written once, from the shapes alone
(K buoys, nt time samples, an nx × ny grid of squares), whatever the
kernel does inside.

  primal ODE     x0 (K, 2) and the half-grid velocity image (2ny+1,
                 2nx+1, 2) in; trajectories and velocities (K, nt, 2)
                 each out, float64; the escape flag and step (K,) int32
  adjoint ODE    trajectories and u − u_d (K, nt, 2), the vertex-grid
                 ∇u image (ny+1, nx+1, 4) and the windows (K,) int32 in,
                 μ (K, nt, 2) out
  point sources  positions and magnitudes (K·nt, 2) in, the half-grid
                 image (2ny+1, 2nx+1, 2) out as two float64 limbs
"""


def primal_ode(K: int, nt: int, nx: int, ny: int) -> int:
    hy, hx = 2 * ny + 1, 2 * nx + 1
    return 8 * (K * 2 + hy * hx * 2 + 2 * K * nt * 2) + 4 * 2 * K


def adjoint_ode(K: int, nt: int, nx: int, ny: int) -> int:
    gy, gx = ny + 1, nx + 1
    return 8 * (3 * K * nt * 2 + gy * gx * 4) + 4 * K


def point_sources(K: int, nt: int, nx: int, ny: int) -> int:
    hy, hx = 2 * ny + 1, 2 * nx + 1
    m = K * nt
    return 8 * (2 * m * 2) + 8 * 2 * hy * hx * 2


KERNELS = {"primal_ode_kernel": primal_ode,
           "adjoint_ode_kernel": adjoint_ode,
           "point_sources_kernel": point_sources}
