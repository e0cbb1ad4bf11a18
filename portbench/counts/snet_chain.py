"""K2 (csrc/snet_levels.cu: snet_conv1, snet_last) with its K1 levels
(csrc/conv3x3_mid.cu): SNet's whole stack at a request's input size, its
logits out (the counts of the program's smoke run, chip_smoke.py
check_kernels)."""

from portbench.counts._shapes import esz, requests, snet_work

KERNELS = ("snet_conv1", "snet_last", "conv3x3_mid_")


def work(cell):
    co, e = cell.config["arch"]["sigma_chn"], esz(cell)
    shapes = requests(cell)
    out = []
    for n, h, w in shapes:
        flops, weights = snet_work(cell, n, h, w)
        nbytes = (n * h * w * (3 + co) + weights) * e
        out.append((flops / len(shapes), nbytes / len(shapes),
                    cell.traffic["compute"]))
    return out
