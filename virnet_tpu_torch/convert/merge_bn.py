"""Fold BatchNorm into the preceding conv or linear layer of a state dict
(counterpart of virnet_tpu/convert/merge_bn.py; reference
networks/SubBlocks.py:12-42, from cszn/DnCNN).

The reference folds a live module tree at inference time.  None of the
released VIRNet architectures holds BatchNorm, so here, as in the JAX
package, the fold is a state-dict transform applied once when a
checkpoint is loaded (``torch_import.load_pth``):

    y = gamma * (W*x + b - mean) / sqrt(var + eps) + beta
      = (W * s) * x + (b - mean) * s + beta,   s = gamma / sqrt(var + eps)

with ``s`` over the layer's output channels: dim 0 of a Conv2d (OIHW) or
Linear (OI) weight, dim 1 of a ConvTranspose2d (IOHW) weight.  A state
dict does not say which of the two 4-D layouts a weight has.  Where the
shape tells (only one dim holds the BatchNorm's channel count) it decides,
as in the JAX package; where both dims hold it (a square conv) the layout
is ambiguous, and the JAX package takes dim 0, wrong for a square
ConvTranspose2d.  Here the caller names the transposed
modules (``transposed``), and without that a square 4-D weight raises.
The arithmetic is in float64 and rounded once to the weight's dtype, the
JAX package's operations in its order, so the two agree bit for bit.
"""

from __future__ import annotations

from typing import Collection, Dict, List, Optional, Tuple

import torch

__all__ = ["fold_bn", "find_conv_bn_pairs", "merge_bn_state_dict"]

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked", "eps")


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().to(torch.float64)


def fold_bn(weight: torch.Tensor, bias: Optional[torch.Tensor],
            running_mean: torch.Tensor, running_var: torch.Tensor,
            gamma: Optional[torch.Tensor] = None,
            beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
            transposed: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one inference-mode BatchNorm into the preceding affine layer.

    ``weight`` is in the torch layout: OIHW (Conv2d), OI (Linear), or IOHW
    when ``transposed`` (ConvTranspose2d).  ``gamma`` / ``beta`` are None
    for a BatchNorm without affine parameters.  Returns (weight, bias) in
    the weight's dtype."""
    w = _f64(weight)
    out_ch = w.shape[1] if transposed else w.shape[0]
    b = torch.zeros(out_ch, dtype=torch.float64) if bias is None \
        else _f64(bias)
    s = torch.ones_like(_f64(running_var)) / torch.sqrt(
        _f64(running_var) + eps)
    if gamma is not None:
        s = s * _f64(gamma)
    shape = [1] * w.ndim
    shape[1 if transposed else 0] = out_ch
    w_f = w * s.reshape(shape)
    b_f = (b - _f64(running_mean)) * s
    if beta is not None:
        b_f = b_f + _f64(beta)
    dt = torch.as_tensor(weight).dtype
    return w_f.to(dt), b_f.to(dt)


def _module_tree(sd: Dict) -> Dict[str, Dict]:
    """Flat state-dict keys grouped by the module that owns them."""
    mods: Dict[str, Dict] = {}
    for k, v in sd.items():
        if "." in k:
            prefix, leaf = k.rsplit(".", 1)
            mods.setdefault(prefix, {})[leaf] = v
    return mods


def find_conv_bn_pairs(sd: Dict) -> List[Tuple[str, str]]:
    """(affine module, BatchNorm module) pairs of a flat state dict: a
    BatchNorm at index N of an ``nn.Sequential`` whose index N - 1 holds a
    2-D or 4-D weight (the reference pairs a BatchNorm with the Conv2d,
    Linear or ConvTranspose2d right before it)."""
    mods = _module_tree(sd)
    pairs: List[Tuple[str, str]] = []
    for name, leaves in mods.items():
        if "running_mean" not in leaves:
            continue
        parent, _, idx = name.rpartition(".")
        if not idx.isdigit():
            continue
        prev = f"{parent}.{int(idx) - 1}" if parent else str(int(idx) - 1)
        pw = mods.get(prev, {}).get("weight")
        if pw is not None and torch.as_tensor(pw).ndim in (2, 4):
            pairs.append((prev, name))
    return pairs


def _is_transposed(name: str, w: torch.Tensor, nch: int,
                   transposed: Optional[Collection[str]]) -> bool:
    if w.ndim != 4:
        return False
    if transposed is not None:
        return name in transposed
    if w.shape[0] == nch and w.shape[1] == nch:
        raise ValueError(
            f"{name}: a square {tuple(w.shape)} weight before a BatchNorm "
            f"of {nch} channels is a Conv2d (OIHW) or a ConvTranspose2d "
            f"(IOHW), and its shape cannot tell which; name the "
            f"ConvTranspose2d modules with transposed=[...] (an empty list "
            f"if there are none)")
    return w.shape[0] != nch and w.shape[1] == nch


def merge_bn_state_dict(sd: Dict, pairs: Optional[List[Tuple[str, str]]]
                        = None,
                        transposed: Optional[Collection[str]] = None
                        ) -> Dict[str, torch.Tensor]:
    """A new state dict with every conv+BN pair (``pairs``, default
    ``find_conv_bn_pairs``) folded into the conv and the BatchNorm's keys
    removed: what the reference's ``merge_bn(model)`` leaves in
    ``model.state_dict()``, to rounding.  ``transposed`` names the
    ConvTranspose2d modules; without it the layout of a 4-D weight is read
    from its shape, and a square one raises (module docstring)."""
    sd = {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}
    if pairs is None:
        pairs = find_conv_bn_pairs(sd)
    out = dict(sd)
    for conv_name, bn_name in pairs:
        w = sd[f"{conv_name}.weight"]
        nch = len(sd[f"{bn_name}.running_mean"])
        eps = sd.get(f"{bn_name}.eps")
        w_f, b_f = fold_bn(
            w, sd.get(f"{conv_name}.bias"), sd[f"{bn_name}.running_mean"],
            sd[f"{bn_name}.running_var"], sd.get(f"{bn_name}.weight"),
            sd.get(f"{bn_name}.bias"),
            eps=1e-5 if eps is None else float(eps),
            transposed=_is_transposed(conv_name, w, nch, transposed))
        out[f"{conv_name}.weight"] = w_f
        out[f"{conv_name}.bias"] = b_f
        for leaf in _BN_LEAVES:
            out.pop(f"{bn_name}.{leaf}", None)
    return out
