"""Run artifacts, checkpoints (``.npz`` in ``checkpoint``, one
``torch.save`` file in ``torch_ckpt``), ParaView export, the figure set
(``plots``, matplotlib imported when a figure is drawn) and the dolfin
HDF5 reader (``dolfin_h5``, h5py imported when a file is read)."""

from . import artifacts, checkpoint, dolfin_h5, plots, torch_ckpt, xdmf
from .artifacts import RunDirectory

__all__ = ["artifacts", "checkpoint", "dolfin_h5", "plots", "torch_ckpt",
           "xdmf", "RunDirectory"]
