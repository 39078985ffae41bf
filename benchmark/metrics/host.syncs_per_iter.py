"""Host syncs a GD iteration: the blocking device-to-host reads and
explicit synchronizes the program counts (``ocean_torch.utils.timing``:
``to_host``, ``sync``) in the traced job, over its ``gd_iteration``
spans. Nothing to read where the program records no spans
(``program_spans``)."""

from benchmark import program_spans


def read(ctx):
    job = program_spans.traced_job(ctx.trace)
    if job is None:
        return None
    iterations = len(job.named("gd_iteration"))
    if not iterations:
        return None
    return sum(s.syncs for s in job.spans) / iterations
