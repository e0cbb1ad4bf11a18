"""The numbers that decide ``correct``, and their limits.

Serving: for every kept request, the gaps of the program's restored image
from the plain reference's (fp32, TF32 off).  Training: the gaps of the
first steps' losses and ELBO terms, of each parameter's first gradient as
Adam got it, and of each parameter's change over the steps, by the worst
parameter tensor ("leaf"): |norm(program) - norm(reference)| over the
larger of the reference's norm of that leaf and of the median leaf.

A cell's ``checks/<cell>.json`` names the numbers it compares and the
limit of each; a number above its limit makes the run not correct.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def scoped_precision(tf32: bool = False):
    """TF32 as asked (off: full fp32) and cuDNN's own timing of its
    algorithms, for the block only."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = saved


def image_gaps(got: np.ndarray, want: np.ndarray) -> dict:
    """Gaps of a restored batch from the reference's, in [0, 1] units: the
    largest absolute difference, its root mean square, the largest mean of
    an image's channel (a systematic shift), and the largest root mean
    square of the difference averaged over 8 x 8 blocks (the error that
    survives a low-pass, as a perturbed weight's does and much of
    pixel-level rounding does not)."""
    keys = ("gap_max", "gap_rms", "gap_mean", "gap_pool8")
    if got.shape != want.shape or not np.isfinite(got).all():
        return dict.fromkeys(keys, math.inf)
    d = got.astype(np.float64) - want.astype(np.float64)
    n, h, w, c = d.shape
    blocks = d[:, :h - h % 8, :w - w % 8].reshape(
        n, h // 8, 8, w // 8, 8, c).mean(axis=(2, 4))
    return dict(zip(keys, (
        float(np.abs(d).max()), float(np.sqrt((d * d).mean())),
        float(np.abs(d.mean(axis=(1, 2))).max()),
        float(np.sqrt((blocks ** 2).mean(axis=(1, 2, 3))).max()))))


def worst_of(stats: list) -> dict:
    """Each number's worst value over the kept requests."""
    return {k: max(s[k] for s in stats) for k in stats[0]} if stats else {}


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(got: dict, want: dict, leaves=None) -> dict:
    """The gap of each leaf's norm, over ``leaves`` (default: all)."""
    g, w = _norms(got), _norms(want)
    keys = list(leaves) if leaves is not None else list(w)
    floor = float(np.median([w[k] for k in keys]))
    return {k: abs(g[k] - w[k]) / max(w[k], floor, 1e-30) for k in keys}


def leaf_gap(got: dict, want: dict, leaves=None) -> tuple:
    """(worst gap, its leaf) of the per-leaf norms, over ``leaves``."""
    gaps = leaf_gaps(got, want, leaves)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_gaps(prog: dict, ref: dict, params0: dict) -> dict:
    """The training cell's numbers; ``prog`` and ``ref`` hold ``loss`` and
    ``terms`` of each step, ``grad1`` and the final ``params``: the gap of
    the first step's loss and of every step's (relative), of the ELBO's
    terms (relative, or to a thousandth of the loss where a term is
    smaller; each term's and the largest), and of the first gradient's
    and the change's per-leaf norms, by the worst leaf and by the median
    leaf.  Leaves whose reference gradient is under a thousandth of the
    median leaf's (nought to rounding: Adam moves them by round-off alone)
    are left out of the change."""
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                     ref["loss"])]
    term = {k: max(abs(pt[k] - rt[k]) / max(abs(rt[k]), 1e-3 * abs(rl))
                   for pt, rt, rl in zip(prog["terms"], ref["terms"],
                                         ref["loss"]))
            for k in ref["terms"][0]}
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    gn = _norms(ref["grad1"])
    med = float(np.median(list(gn.values())))
    moving = [k for k in gn if gn[k] >= 1e-3 * med]
    change = leaf_gaps({k: prog["params"][k] - params0[k] for k in moving},
                       {k: ref["params"][k] - params0[k] for k in moving})
    grad_leaf = max(grad, key=grad.get)
    change_leaf = max(change, key=change.get)
    return dict(loss1_gap=loss_gaps[0], loss_gap=max(loss_gaps),
                terms_gap=max(term.values()),
                **{f"{k}_gap": v for k, v in term.items()},
                grad_gap=grad[grad_leaf],
                grad_gap_median=float(np.median(list(grad.values()))),
                change_gap=change[change_leaf],
                change_gap_median=float(np.median(list(change.values()))),
                grad_leaf=grad_leaf, change_leaf=change_leaf,
                leaves_left_out=len(gn) - len(moving))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the limited numbers; a number
    that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        good = isinstance(value, (int, float)) and math.isfinite(value) \
            and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok and bool(limits), rows
