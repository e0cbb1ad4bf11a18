"""Shapes of a cell's requests that the kernels' counts share."""

from __future__ import annotations


def requests(cell) -> list:
    """[(n, h, w)] of the input of each request shape in the mix, and the
    fraction of requests each takes (the shapes alternate)."""
    t = cell.traffic
    return [(t["batch"], h, w) for h, w in t["shapes"]]


def esz(cell) -> int:
    return 2 if cell.traffic["compute"] == "bf16" else 4


def snet_work(cell, n, h, w):
    """K2 / K3's SNet part: 3x3 convs 3 -> 64, L x 64 -> 64, 64 -> co."""
    a = cell.config["arch"]
    L, co = a["dep_S"] - 2, a["sigma_chn"]
    flops = 2 * 9 * (3 * 64 + L * 64 * 64 + 64 * co) * n * h * w
    weights = 27 * 64 + 64 + L * (9 * 64 * 64 + 64) + 9 * 64 * co + co
    return flops, weights
