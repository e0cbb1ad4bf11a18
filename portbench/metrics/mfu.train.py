"""Model FLOPs per second over the untraced window (core/flops.py counts
them from the configuration's conv shapes; a training step counts three
forwards), over the data-sheet peak of the cell's compute, in %."""


def read(ctx):
    out = ctx.out
    if ctx.device.type != "cuda" or not out.attempted:
        return None
    rate = out.unit_flops * out.attempted / out.window_s
    return 100.0 * rate / ctx.peaks[out.compute]
