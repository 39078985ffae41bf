"""Gen-1 compatibility layer (port of ``ocean_jax/gen1``).

The reference keeps an older, class-structured dolfinx implementation
(``old_dolfinx_files/``) whose API — solver classes with
``solve_stokes_step`` / ``state_solving_step`` / ``ode_solving_step`` /
``adjoint_ode_solving_step`` / ``adjoint_state_solving_step`` — this
package provides over the port's assembly and solves, with the gen-1
weak-form variants (tanh-regularized backflow, opposite pressure sign,
viscous adjoint) and the gen-1 FD-verification helpers.
"""

from .solvers import NavierStokesSolver, ODESolver
from . import helpers

__all__ = ["NavierStokesSolver", "ODESolver", "helpers"]
