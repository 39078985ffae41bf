from .spaces import (
    TaylorHoodSpace,
    BoundaryQuad,
    make_space,
    make_boundary_quad,
    dirichlet_velocity_bc,
    dirichlet_pressure_bc,
    combine_bcs,
)
from . import assemble, forms, interpolate, reference

__all__ = [
    "TaylorHoodSpace", "BoundaryQuad", "make_space", "make_boundary_quad",
    "dirichlet_velocity_bc", "dirichlet_pressure_bc", "combine_bcs",
    "assemble", "forms", "interpolate", "reference",
]
