"""Run artifacts, checkpoints and ParaView export (the figure set of
``ocean_jax/io/plots.py`` and the dolfin HDF5 reader are not ported
yet)."""

from . import artifacts, checkpoint, xdmf

__all__ = ["artifacts", "checkpoint", "xdmf"]
