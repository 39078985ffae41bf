from .primal import solve_primal_ode, PrimalODEResult
from .adjoint import solve_adjoint_ode
from .cuda_ode import solve_primal_ode_cuda
from .cuda_adjoint import solve_adjoint_ode_cuda

__all__ = ["solve_primal_ode", "PrimalODEResult", "solve_adjoint_ode",
           "solve_primal_ode_cuda", "solve_adjoint_ode_cuda"]
