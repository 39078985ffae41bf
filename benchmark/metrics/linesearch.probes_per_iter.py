"""Line-search probes an iteration: the GD loop's ``inner_iterations``
(each forward solve of the Armijo loop, the accepting one included) over
the iterations of the window's whole jobs."""


def read(ctx):
    inner = ctx.window["inner_iterations"]
    return sum(inner) / len(inner) if inner else None
