"""K3 (csrc/dncnn_head.cu): SNet, sigma and RNet's head conv on
[x | sqrt(sigma)] in one launch, at a request's input size (the counts of
the program's smoke run, chip_smoke.py check_kernels)."""

from portbench.counts._shapes import esz, requests, snet_work

KERNELS = ("dncnn_head_",)


def work(cell):
    a = cell.config["arch"]
    co, cf, e = a["sigma_chn"], a["n_feat"][0], esz(cell)
    shapes = requests(cell)
    out = []
    for n, h, w in shapes:
        npx = n * h * w
        flops, weights = snet_work(cell, n, h, w)
        flops += 2 * 9 * (3 + co) * cf * npx
        nbytes = (npx * (3 + co + cf) + weights + 9 * (3 + co) * cf + cf) * e
        out.append((flops / len(shapes), nbytes / len(shapes),
                    cell.traffic["compute"]))
    return out
