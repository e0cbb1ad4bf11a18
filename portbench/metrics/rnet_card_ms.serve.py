"""Card ms a request of RNet (span ``model.rnet``: on the fused path the
body after the head, ``restore_from_head``; on the unfused path RNet whole,
its pad and head conv included; K4 on both), from the span's timing events
on the current stream, the median over the traced requests (one root span
``engine.restore_batch`` or ``engine.restore_image`` a request, read by
virnet_tpu_torch/eval/profiling.py); None where the program records no such
span, and off the card."""

ROOTS = ("engine.restore_batch", "engine.restore_image")


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None or ctx.device.type != "cuda":
        return None
    return median("card_ms", "model.rnet", ROOTS)
