"""Share of the bandwidth roofline reached by the buoy path's CUDA
kernels (primal ODE, adjoint ODE, point sources), weighted by time: the
least time by bytes of every launch in the traced job
(``kernel_bytes``, at 3.35 TB/s) over their device time. Nothing to read
where none of them ran."""

from benchmark import kernel_bytes, peaks


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    cfg = ctx.cfg
    n = cfg["resolution"]
    nt = int(round(cfg["T"] / cfg["dt"]))
    bound = spent = 0.0
    for name, (sec, launches) in tr.kernels_named(
            list(kernel_bytes.KERNELS)).items():
        nbytes = kernel_bytes.KERNELS[name](ctx.K, nt, n, n)
        bound += launches * nbytes / peaks.HBM_BYTES_PER_S
        spent += sec
    return 100.0 * bound / spent if spent > 0 else None
