"""FGMRES restart cycles a multigrid Newton step: the ``krylov_cycles``
of the ``ns_newton`` records that the program appends to
``prob.solve_log`` during the window (one entry a step, line-search
probes included), over their number. Nothing to read where no solve
took a Krylov step (the dense Newton logs none)."""


def read(ctx):
    cycles = [c for r in ctx.solve_log if r.get("solve") == "ns_newton"
              for c in r.get("krylov_cycles", ())]
    return sum(cycles) / len(cycles) if cycles else None
