"""ocean_torch — the PyTorch/CUDA port of ``ocean_jax``.

Same problem, same algorithms, same array layouts at every public
boundary as ``ocean_jax``; the JAX package stays the reference the port
is tested against (``tests/test_torch_*.py``). Plain tensor code is
PyTorch in float64 throughout; the five kernels (primal buoy ODE,
adjoint buoy ODE, fused point sources, ∇u point evaluation, Ozaki
segment sum) are hand-written CUDA C++ for Hopper (``csrc/``), each with
a plain PyTorch twin beside it.

This package imports neither ``jax`` nor ``ocean_jax``. Importing it
imports the ten subpackages, as ``import ocean_jax`` does, and neither
initializes CUDA nor imports matplotlib or h5py (``io.plots`` and
``io.dolfin_h5`` import them when a figure is drawn or a file read).

Entry points (``system.build_problem``, ``pipelines.limits.ensure_ud``,
``pipelines.ud_construction.run``, ``fem.make_space``,
``fem.make_boundary_quad``, ``io.torch_ckpt.load_control``) take a
``device`` argument that defaults to ``"cuda"`` and raise when no card is
present unless the caller asks for ``device="cpu"``.
"""

from .device import resolve_device
from . import (mesh, fem, ops, solve, ode, adjoint, opt, io,  # noqa: F401
               parallel, pipelines)
from .config import OCPConfig, load_parameters

__all__ = ["resolve_device", "OCPConfig", "load_parameters", "mesh", "fem",
           "ops", "solve", "ode", "adjoint", "opt", "io", "parallel",
           "pipelines"]
