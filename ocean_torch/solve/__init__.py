from .newton import newton_solve, NewtonResult
from .linear import solve_operator, solve_operator_reuse_t
from .projection import GradProjector

__all__ = ["newton_solve", "NewtonResult", "solve_operator",
           "solve_operator_reuse_t", "GradProjector"]
