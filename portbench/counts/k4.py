"""K4 (csrc/tail_residual.cu): RNet's tail conv (n_feat[0] -> 3) and the
global residual, at a request's output size; the features are read at
RNet's padded size, the image in and the result out in fp32 (the counts
of the program's smoke run, chip_smoke.py check_kernels)."""

from portbench.counts._shapes import esz, requests

KERNELS = ("tail_kernel",)


def work(cell):
    a = cell.config["arch"]
    cf, e, sf = a["n_feat"][0], esz(cell), cell.config.get("sf", 1)
    mod = 2 ** (len(a["n_feat"]) - 1)
    shapes = requests(cell)
    out = []
    for n, h, w in shapes:
        hh, ww = h * sf, w * sf
        hp, wp = -(-hh // mod) * mod, -(-ww // mod) * mod
        npx = n * hh * ww
        flops = 2 * 9 * cf * 3 * npx
        nbytes = n * hp * wp * cf * e + npx * 3 * 4 * 2 + (9 * cf * 3 + 3) * e
        out.append((flops / len(shapes), nbytes / len(shapes),
                    cell.traffic["compute"]))
    return out
