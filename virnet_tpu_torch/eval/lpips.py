"""LPIPS-AlexNet perceptual metric (counterpart of
virnet_tpu/eval/lpips.py).

The reference scores SISR with LPIPS-alex (scripts/sisr_virnet_syn.py:96,
158-161) through the `lpips` torch package.  ``LPIPSAlex`` is the published
LPIPS v0.1 network (Zhang et al., CVPR 2018): torchvision AlexNet's feature
stack tapped after each of its five ReLUs, each tap unit-normalised over
channels, squared-differenced, weighted by the learned non-negative 1x1
"lin" weights, averaged over space and summed over taps.  It is that
package's network, so the JAX package's fallback to the package is not
needed; the package is not installed on the card's machine either.

Weights are not bundled (third-party files).  ``VIRNET_LPIPS_WEIGHTS`` (or
the default ``model_zoo/lpips_alex.pth``) points at a torch file holding
either
  * a full ``lpips.LPIPS(net='alex')`` state dict
    (``net.sliceK.N.weight`` + ``linK.model.1.weight`` keys), or
  * ``{"alex": <torchvision alexnet state dict>, "lin": <lpips lin state
    dict>}`` for the two upstream files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..precision import parity_mode

DEFAULT_WEIGHTS = "model_zoo/lpips_alex.pth"

# lpips v0.1 ScalingLayer constants (RGB, inputs in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision AlexNet features: (in, out, kernel, stride, pad); a 3x3/2
# max-pool precedes conv2 and conv3
_CONV_SPECS = [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
               (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
_TV_IDX = [0, 3, 6, 8, 10]          # conv positions in alexnet.features


def _find(sd, candidates) -> Optional[torch.Tensor]:
    for k in candidates:
        if k in sd:
            return torch.as_tensor(sd[k]).detach().float().cpu()
    return None


def load_lpips_params(path_or_sd) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`LPIPSAlex` from a torch file (path) or an
    already loaded state dict or {"alex", "lin"} pair, in either layout."""
    obj = (torch.load(path_or_sd, map_location="cpu", weights_only=True)
           if isinstance(path_or_sd, (str, os.PathLike)) else path_or_sd)
    if isinstance(obj, dict) and "alex" in obj and "lin" in obj:
        sd = dict(obj["alex"])
        sd.update(obj["lin"])
    else:
        sd = dict(obj)

    params: Dict[str, torch.Tensor] = {}
    for k, idx in enumerate(_TV_IDX):
        w = _find(sd, [f"net.slice{k + 1}.{idx}.weight",
                       f"features.{idx}.weight"])
        b = _find(sd, [f"net.slice{k + 1}.{idx}.bias",
                       f"features.{idx}.bias"])
        if w is None or b is None:
            raise ValueError(f"conv{k + 1} weights not found (tried lpips "
                             f"and torchvision key layouts)")
        params[f"convs.{k}.weight"] = w
        params[f"convs.{k}.bias"] = b
        lw = _find(sd, [f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight",
                        f"lin{k}.weight"])
        if lw is None:
            raise ValueError(f"lin{k} calibration weights not found")
        params[f"lin{k}"] = lw.reshape(-1)
    shift = _find(sd, ["scaling_layer.shift"])
    scale = _find(sd, ["scaling_layer.scale"])
    params["shift"] = (shift.reshape(-1) if shift is not None
                       else torch.tensor(_SHIFT))
    params["scale"] = (scale.reshape(-1) if scale is not None
                       else torch.tensor(_SCALE))
    return params


class LPIPSAlex(nn.Module):
    """LPIPS v0.1 with the AlexNet trunk; ``forward(x0, x1)`` takes NHWC
    batches in [-1, 1] and returns the (N,) distances."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, k, s, p)
                                   for ci, co, k, s, p in _CONV_SPECS)
        for k, (_, co, *_) in enumerate(_CONV_SPECS):
            self.register_buffer(f"lin{k}", torch.zeros(co))
        self.register_buffer("shift", torch.zeros(3))
        self.register_buffer("scale", torch.ones(3))
        self.load_state_dict(params, strict=True)

    def _feats(self, x: torch.Tensor):
        h = (x.permute(0, 3, 1, 2) - self.shift[:, None, None]) \
            / self.scale[:, None, None]
        feats = []
        for k, conv in enumerate(self.convs):
            if k in (1, 2):
                h = F.max_pool2d(h, 3, 2)
            h = F.relu(conv(h))
            feats.append(h)
        return feats

    @staticmethod
    def _unit_norm(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
        return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        val = torch.zeros(x0.shape[0], device=x0.device)
        for k, (f0, f1) in enumerate(zip(self._feats(x0), self._feats(x1))):
            d = (self._unit_norm(f0) - self._unit_norm(f1)) ** 2
            lin = torch.sum(d * getattr(self, f"lin{k}")[:, None, None],
                            dim=1)
            val = val + lin.mean(dim=(1, 2))
        return val


# ------------------------------------------------------------------ metric API

_PARAMS: Optional[Dict[str, torch.Tensor]] = None
_NETS: Dict[str, LPIPSAlex] = {}     # device -> the network on it


def _weights_path() -> Optional[str]:
    p = os.environ.get("VIRNET_LPIPS_WEIGHTS", DEFAULT_WEIGHTS)
    return p if os.path.exists(p) else None


def skip_reason() -> str:
    """The reason recorded in eval results when LPIPS cannot be scored."""
    p = os.environ.get("VIRNET_LPIPS_WEIGHTS", DEFAULT_WEIGHTS)
    return (f"skipped (no weights at {p}; set VIRNET_LPIPS_WEIGHTS to a "
            "torch lpips-alex checkpoint — formats in eval/lpips.py)")


def available() -> bool:
    """True when weights were set or a weights file is found."""
    return _PARAMS is not None or _weights_path() is not None


def set_params(params: Dict[str, torch.Tensor]) -> None:
    """Install loaded LPIPS weights (e.g. from load_lpips_params)."""
    global _PARAMS
    _PARAMS = params
    _NETS.clear()


def _net(device) -> LPIPSAlex:
    if _PARAMS is None:
        path = _weights_path()
        if path is None:
            raise RuntimeError(
                "LPIPS weights not found: set VIRNET_LPIPS_WEIGHTS to a "
                "torch lpips-alex checkpoint (or place it at "
                f"{DEFAULT_WEIGHTS})")
        set_params(load_lpips_params(path))
    key = str(torch.device(device))
    if key not in _NETS:
        _NETS[key] = LPIPSAlex(_PARAMS).to(device).eval()
    return _NETS[key]


def normalize_lpips(im_uint8: np.ndarray) -> np.ndarray:
    """HWC uint8 -> 1xHxWx3 float32 in [-1, 1] (reference
    utils/util_image.py:118-126 semantics, NHWC layout)."""
    return ((im_uint8.astype(np.float32) - 127.5) / 127.5)[None]


def lpips_rgb(im1_uint8: np.ndarray, im2_uint8: np.ndarray,
              device="cuda") -> float:
    """LPIPS-alex between two HWC uint8 images (reference
    scripts/sisr_virnet_syn.py:158-161), on ``device`` in fp32 (TF32 off)."""
    net = _net(device)
    x0, x1 = (torch.from_numpy(normalize_lpips(im)).to(device)
              for im in (im1_uint8, im2_uint8))
    with torch.inference_mode(), parity_mode():
        return float(net(x0, x1)[0])
