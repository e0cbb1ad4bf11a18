"""Card ms a request of RNet below its top level (span ``model.rnet.deep``
of models/attresunet.py: from level 0's downsampler to where the last up
block begins, every block, sampler and skip add of the levels below the
top), from the span's timing events on the current stream, the median over
the traced requests (one root span ``engine.restore_batch`` or
``engine.restore_image`` a request, read by
virnet_tpu_torch/eval/profiling.py); None where the program records no such
span, and off the card."""

ROOTS = ("engine.restore_batch", "engine.restore_image")


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None or ctx.device.type != "cuda":
        return None
    return median("card_ms", "model.rnet.deep", ROOTS)
