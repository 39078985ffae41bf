"""Share of the device's busy time in dense linear algebra: the kernels
of cuBLAS, cuSOLVER, MAGMA and CUTLASS, found by these parts of their
names (compared in lower case), over the union of all device activity
in the traced job."""

PATTERNS = ("gemm", "gemv", "trsm", "trsv", "getrf", "getf2", "getrs",
            "laswp", "cusolver", "cublas", "magma", "xmma", "cutlass",
            "dgemm", "sgemm", "ger_kernel", "iamax", "swap_kernel",
            "lu_")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    lin = sum(s for name, s in tr.time_by_kernel().items()
              if any(p in name.lower() for p in PATTERNS))
    return 100.0 * lin / busy
