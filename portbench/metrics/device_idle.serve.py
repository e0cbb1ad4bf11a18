"""The share of the traced window in which the card had nothing to run, in
%: one less the device-busy time (kernels and copies, merged where they
overlap) over the traced window's host-clock length, both of the same
profiled calls (the result's ``busy_s`` and ``window_s``).  The profiler
makes each launch dearer, so in a cell whose card waits on the host's
launches this reads above the untraced window's idle share."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.device.type != "cuda" or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
