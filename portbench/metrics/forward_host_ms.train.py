"""Host ms a step in the autocast forward of VIRNetSR (span
``train.forward`` of train/loop_sisr.py), the median over the traced steps
(one root span ``train.step`` a step, read by
virnet_tpu_torch/eval/profiling.py); None where the program records no such
span."""

ROOTS = ("train.step",)


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None:
        return None
    return median("host_ms", "train.forward", ROOTS)
