"""Seconds of the problem build, the sum of the parts the program
records in ``prob.setup_seconds`` (mesh and space, the Stokes factor or
inverse, the projector, the grid tables)."""


def read(ctx):
    parts = ctx.setup_seconds
    return sum(parts.values()) if parts else None
