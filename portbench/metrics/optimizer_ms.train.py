"""Device ms a training step in the optimizer's kernels: the per-subnet
gradient norms and clip and Adam's multi-tensor update."""

KEYS = ("multi_tensor", "adam", "foreach", "lpnorm")


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_unit(lambda n: any(k in n.lower() for k in KEYS))
    return ms if ms > 0 else None
