"""Share of the FP64 tensor-core roofline reached by the dense LU
factorizations of the traced job: 2/3 n^3 operations for each matrix of
each ``torch.linalg.lu_factor_ex`` call (n from its input's shape), at
the published 67 TFLOP/s, over the device time of the kernels and
memsets that the call launched (``tracing.lu_device_seconds``). An LU
whose launches the trace does not hold counts neither its operations nor
its time. Nothing to read where the traced job factorizes nothing."""

from benchmark import peaks


def read(ctx):
    tr = ctx.trace
    lus = [lu for lu in (tr.lu if tr is not None else []) if lu[2] > 0]
    if not lus:
        return None
    flops = sum(2.0 / 3.0 * n ** 3 * batch for n, batch, _ in lus)
    dev = sum(d for _, _, d in lus)
    return 100.0 * (flops / peaks.FP64_TENSOR_FLOP_PER_S) / dev
