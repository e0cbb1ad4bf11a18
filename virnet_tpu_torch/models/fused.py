"""The fused denoise prologue (counterpart of virnet_tpu/models/fused.py):
SNet, sigma = exp(clip(logits)), sqrt(sigma) and RNet's head conv on
[x | sqrt(sigma)] through K3 (ops/fused_conv.dncnn_head_fused: the SNet
level chain, its last level computing sigma and the head conv), then RNet
continues from the head activation.  It applies to the denoising
VIRNet with extra_mode 'input', at sizes where RNet's reflect pad is a
no-op.  ``mode='slabzero'`` runs the halo-free probe K8 in K3's place: a
measurement tool with wrong values near slab edges, reached only through
cli/bench_fused_head.
"""

from __future__ import annotations

import torch

from ..eval.profiling import span
from ..ops import fused_conv as fc
from .common import conv_hwio
from .virnet import LOG_MAX, LOG_MIN, VIRNet


def fused_head_supported(model, shape) -> bool:
    """True when (model, NHWC input shape) takes the fused prologue: the
    SNet runs fused, extra_mode is 'input', and H, W are multiples of
    2^(depth-1) with W even."""
    if not isinstance(model, VIRNet) or model.conv_impl != "fused":
        return False
    if not model.noise_cond or model.extra_mode != "input":
        return False
    h, w = shape[-3], shape[-2]
    mod = 2 ** (len(model.n_feat) - 1)
    return h % mod == 0 and w % mod == 0 and w % 2 == 0


def denoise_forward_fused(model: VIRNet, x: torch.Tensor, mode: str = "halo",
                          rows=None):
    """(mu, sigma) through the fused prologue and the RNet continuation.
    ``mode``: 'halo' or 'carry' run K3 (on Hopper the two are one kernel,
    and ``rows`` means nothing to it); 'slabzero' runs the probe K8 on
    ``rows``-row slabs (default 32; must divide H), whose output is wrong
    near slab edges (ops/fused_conv.dncnn_head_slabzero)."""
    if mode not in ("halo", "carry", "slabzero"):
        raise ValueError(f"mode must be halo|carry|slabzero, got {mode!r}")
    with span("model.snet"):
        p = model.SNet.kernel_params()
        head_conv = model.RNet.head
        xk = x.to(model.dtype).contiguous()
        args = (xk, p["w1"], p["b1"], p["wms"], p["bms"], p["wl"], p["bl"],
                conv_hwio(head_conv), head_conv.bias)
        kw = dict(slope=model.SNet.slope, lmin=LOG_MIN, lmax=LOG_MAX)
        if mode == "slabzero":
            head, sigma = fc.dncnn_head_slabzero(
                *args, rows=32 if rows is None else int(rows), **kw)
        else:
            head, sigma = fc.dncnn_head_fused(*args, **kw)
    with span("model.rnet"):
        return model.restore_from_head(x, head), sigma
