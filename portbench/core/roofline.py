"""A kernel's share of its roofline: the least time the card could take
for the kernel's work (the larger of its operations over the peak of its
compute and its bytes over the memory bandwidth, each input byte read once
and each output byte written once), over the device time the trace gives
its kernels, as a percentage.  The work comes from ``counts/<kernel>.py``:
``KERNELS`` (name fragments of its device functions) and ``work(cell)``,
[(flops, bytes, compute)] per request or step."""

from __future__ import annotations


def least_s(work, peaks) -> float:
    return sum(max(f / peaks[dtype], b / peaks["bytes"])
               for f, b, dtype in work)


def share(ctx, kernel: str):
    """The share in %, or None where the trace holds none of its kernels."""
    if ctx.trace is None or ctx.device.type != "cuda":
        return None
    count = ctx.counts(kernel)
    dev_ms = ctx.trace.ms_per_unit(
        lambda n: any(k in n for k in count.KERNELS))
    if dev_ms <= 0:
        return None
    return 100.0 * least_s(count.work(ctx.cell), ctx.peaks) / (dev_ms / 1e3)
