"""Multi-device GD steps over ``torch.distributed`` (port of
``ocean_jax/parallel``): the buoy-sharded step, the dof×buoy-sharded step
with the cell-sharded multigrid matvec, and ``launch.spawn`` to start the
ranks on one host."""

from .sharding import (make_buoy_group, make_2d_groups, make_sharded_step,
                       make_sharded_step_2d, pad_buoys, pad_problem)
from .dof_sharding import make_sharded_matvec
from . import launch

__all__ = ["make_buoy_group", "make_2d_groups", "make_sharded_step",
           "make_sharded_step_2d", "pad_buoys", "pad_problem",
           "make_sharded_matvec", "launch"]
