"""K11 (csrc/resblock_conv.cu): RNet's unconditioned body blocks, each two
launches at its level's size, bf16: 'first' ``lrelu(conv(lrelu(x)) + b1)``
and 'second' ``x + conv(y) + b2``.  Each is 2 * 9 * Ci * Co FLOPs a pixel
with Co padded to the kernel's splits x N (the program's
ops/resblock.plan); its input read once, in 'second' the block's input
(the residual) read once more, its output written once, and its weights
in the kernel's padded layout and its bias read once.  A level's size is
RNet's padded input (a multiple of 2^(depth - 1)) halved once a level."""

from portbench.counts._shapes import requests

KERNELS = ("resblock_conv_",)
WIDTHS = (112, 96, 80, 64)     # the N of the kernel's builds


def plan(co: int) -> tuple:
    """(N, splits): the width of ``WIDTHS`` that computes the fewest
    padded channels, then the one of fewest splits."""
    n = min(WIDTHS, key=lambda w: (-(-co // w) * w, -(-co // w)))
    return n, -(-co // n)


def blocks(arch: dict) -> list:
    """Unconditioned body blocks a forward runs at each level: the down
    path's unless the extra maps condition it, and the up path's below the
    bottom level."""
    nf, r = arch["n_feat"], arch["n_resblocks"]
    cond_down = arch["extra_mode"].lower() in ("down", "both")
    depth = len(nf)
    return [(0 if cond_down else r) + (r if i + 1 < depth else 0)
            for i in range(depth)]


def work(cell):
    a = cell.config["arch"]
    nf = a["n_feat"]
    mod = 2 ** (len(nf) - 1)
    sf = cell.config.get("sf", 1)
    shapes = requests(cell)
    out = []
    for n, h, w in shapes:
        hp, wp = -(-h * sf // mod) * mod, -(-w * sf // mod) * mod
        for level, (c, count) in enumerate(zip(nf, blocks(a))):
            if not count:
                continue
            npx = n * (hp >> level) * (wp >> level)
            width, splits = plan(c)
            cop = width * splits
            flops = 2 * 9 * c * cop * npx
            weights = 9 * c * cop + c
            for reads in (1, 2):      # 'first': x; 'second': y and x
                nbytes = 2 * (npx * c * (reads + 1) + weights)
                out.append((count * flops / len(shapes),
                            count * nbytes / len(shapes), "bf16"))
    return out
