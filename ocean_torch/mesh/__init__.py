from .structured import (
    Mesh2D,
    rectangle_mesh,
    unit_square_mesh,
    mark_boundary_facets,
)
from .locate import Locator, in_domain, locate_points

__all__ = [
    "Mesh2D",
    "rectangle_mesh",
    "unit_square_mesh",
    "mark_boundary_facets",
    "Locator",
    "in_domain",
    "locate_points",
]
