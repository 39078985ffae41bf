from .primal import solve_primal_ode, PrimalODEResult
from .adjoint import (solve_adjoint_ode, solve_adjoint_ode_consistent,
                      solve_adjoint_ode_implicit)
from .cuda_ode import solve_primal_ode_cuda
from .cuda_table_ode import solve_primal_ode_table_cuda
from .cuda_adjoint import solve_adjoint_ode_cuda
from .cuda_eval import eval_p1_tensor_cuda

__all__ = ["solve_primal_ode", "PrimalODEResult", "solve_adjoint_ode",
           "solve_adjoint_ode_consistent", "solve_adjoint_ode_implicit",
           "solve_primal_ode_cuda", "solve_primal_ode_table_cuda",
           "solve_adjoint_ode_cuda", "eval_p1_tensor_cuda"]
