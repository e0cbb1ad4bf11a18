"""Host ms a step in the SISR ELBO (span ``train.elbo`` of
train/loop_sisr.py: losses/elbo.elbo_sisr with its blur kernels), the median
over the traced steps (one root span ``train.step`` a step, read by
virnet_tpu_torch/eval/profiling.py); None where the program records no such
span."""

ROOTS = ("train.step",)


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None:
        return None
    return median("host_ms", "train.elbo", ROOTS)
