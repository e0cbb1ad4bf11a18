"""Card ms a request of SNet (span ``model.snet``: on the fused path K3,
which computes SNet, sigma and RNet's head conv; on the unfused path SNet,
its sigma epilogue and sqrt), from the span's timing events on the current
stream, the median over the traced requests (one root span
``engine.restore_batch`` or ``engine.restore_image`` a request, read by
virnet_tpu_torch/eval/profiling.py); None where the program records no such
span, and off the card."""

ROOTS = ("engine.restore_batch", "engine.restore_image")


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None or ctx.device.type != "cuda":
        return None
    return median("card_ms", "model.snet", ROOTS)
