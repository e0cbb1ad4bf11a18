"""How far the card's work ran behind the host at the end of each step, in
ms: the card end less the host end of the root span ``train.step``, both on
the host's clock (eval/profiling.py anchors the card's events to it). Near 0
the card waits on the host's launches; the median over the traced steps,
None where the program records no such span or off the card."""

ROOTS = ("train.step",)


def read(ctx):
    from virnet_tpu_torch.eval import profiling

    median = getattr(profiling, "call_median", None)
    if median is None or ctx.device.type != "cuda":
        return None
    return median("queue_ms", None, ROOTS)
