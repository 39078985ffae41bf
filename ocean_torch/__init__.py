"""ocean_torch — the PyTorch/CUDA port of ``ocean_jax``.

Same problem, same algorithms, same array layouts at every public
boundary as ``ocean_jax``; the JAX package stays the reference the port
is tested against (``tests/test_torch_*.py``). Plain tensor code is
PyTorch in float64 throughout; the three kernels of the main path (primal
buoy ODE, adjoint buoy ODE, fused point sources) are hand-written CUDA
C++ for Hopper (``csrc/``), each with a plain PyTorch twin beside it.

This package imports neither ``jax`` nor ``ocean_jax``.

Entry points (``system.build_problem``, ``pipelines.limits.ensure_ud``,
``pipelines.ud_construction.run``) take a ``device`` argument that
defaults to ``"cuda"`` and raise when no card is present unless the
caller asks for ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
