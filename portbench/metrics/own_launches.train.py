"""Hand-written kernel launches a step (the increase of the sum of
ops/fused_conv.LAUNCHES over the root span ``train.step``), the median over
the traced steps (one root span ``train.step`` a step, read by
virnet_tpu_torch/eval/profiling.py); None where the program records no such
span, and off the card, where no kernel is launched."""

ROOTS = ("train.step",)


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None or ctx.device.type != "cuda":
        return None
    return median("launches", None, ROOTS)
