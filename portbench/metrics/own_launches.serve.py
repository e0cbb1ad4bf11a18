"""Hand-written kernel launches a request (the increase of the sum of
ops/fused_conv.LAUNCHES over the root span), the median over the traced
requests (one root span ``engine.restore_batch`` or ``engine.restore_image``
a request, read by virnet_tpu_torch/eval/profiling.py); None where the
program records no such span, and off the card, where no kernel is
launched."""

ROOTS = ("engine.restore_batch", "engine.restore_image")


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None or ctx.device.type != "cuda":
        return None
    return median("launches", None, ROOTS)
