"""Host ms a request in the Restorer's copy-out (span ``engine.copy_out``
of eval/engine.py: the restored batch copied from the card into a
page-locked host block, once the forward has finished), the median over
the traced requests (one root span ``engine.restore_batch`` or
``engine.restore_image`` a request, read by
virnet_tpu_torch/eval/profiling.py); None where the program records no
such span."""

ROOTS = ("engine.restore_batch", "engine.restore_image")


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None:
        return None
    return median("host_ms", "engine.copy_out", ROOTS)
