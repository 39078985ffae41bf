from . import linalg
from . import stencil
from .linalg import LUSolver, factorize, solve_refined
from .stencil import StencilTables, build_stencil_tables, stencil_matvec

__all__ = ["linalg", "stencil", "LUSolver", "factorize", "solve_refined",
           "StencilTables", "build_stencil_tables", "stencil_matvec"]
