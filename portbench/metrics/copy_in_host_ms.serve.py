"""Host ms a request in the Restorer's copy-in (span ``engine.copy_in`` of
eval/engine.py: the numpy batch made a float32 tensor and moved to the card,
the host's staging of a pageable array included), the median over the traced
requests (one root span ``engine.restore_batch`` or ``engine.restore_image``
a request, read by virnet_tpu_torch/eval/profiling.py); None where the
program records no such span."""

ROOTS = ("engine.restore_batch", "engine.restore_image")


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None:
        return None
    return median("host_ms", "engine.copy_in", ROOTS)
