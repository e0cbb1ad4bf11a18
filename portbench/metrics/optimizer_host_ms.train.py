"""Host ms a step in the optimizer (span ``optim.step`` of train/optim.py:
the per-subnet norms, the clip and Adam), the median over the traced steps
(one root span ``train.step`` a step, read by
virnet_tpu_torch/eval/profiling.py); None where the program records no such
span."""

ROOTS = ("train.step",)


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None:
        return None
    return median("host_ms", "optim.step", ROOTS)
