"""Checkpoints for the port.

The port's parameter names are the reference torch keys, so a released
``.pth`` loads with ``load_state_dict(strict=True)`` once ``module.`` is
stripped and fp16 is cast to fp32 (``load_pth``).  ``from_jax_params``
carries a virnet_tpu (flax) parameter tree, given as numpy arrays, across
to a state dict: the counterpart of
virnet_tpu/convert/torch_export.py:export_state_dict.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def load_pth(path) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` (a bare state dict or the trainer's
    {'model_state_dict': ...} wrapper) as an fp32 state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return {k.removeprefix("module."): v.float() for k, v in ckpt.items()}


def _conv(sd: Dict, name: str, tree: Dict) -> None:
    """flax {'kernel': HWIO, 'bias'} -> torch OIHW weight + bias."""
    sd[f"{name}.weight"] = np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in tree:
        sd[f"{name}.bias"] = np.asarray(tree["bias"])


def _block(sd: Dict, prefix: str, tree: Dict) -> None:
    _conv(sd, f"{prefix}.conv1", tree["conv1"])
    _conv(sd, f"{prefix}.conv2", tree["conv2"])
    for sft in ("sft1", "sft2"):
        if sft in tree:
            for name in ("conv1", "conv2", "mul_conv", "add_conv"):
                _conv(sd, f"{prefix}.{sft}.{name}", tree[sft][name])


def from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """virnet_tpu VIRNet parameter tree (numpy leaves; with or without the
    top 'params' level) -> the port's fp32 state dict."""
    params = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    snet = params["snet"]
    _conv(sd, "SNet.conv1", snet["conv1"])
    n_mid = sum(1 for k in snet if k.startswith("mid_"))
    for ii in range(1, n_mid + 1):
        _conv(sd, f"SNet.mid_layer.{2 * (ii - 1)}", snet[f"mid_{ii}"])
    _conv(sd, "SNet.conv_last", snet["conv_last"])

    rnet = params["rnet"]
    depth = 1 + sum(1 for k in rnet if k.startswith("up_"))
    n_res = sum(1 for k in rnet if k.startswith("down_0_block_"))
    _conv(sd, "RNet.head", rnet["head"])
    for ii in range(depth):
        for jj in range(n_res):
            _block(sd, f"RNet.down_path.{ii}.body.{jj}",
                   rnet[f"down_{ii}_block_{jj}"])
        if ii + 1 < depth:
            _conv(sd, f"RNet.down_path.{ii}.downsampler",
                  rnet[f"down_{ii}_sampler"])
    for k in range(depth - 1):
        up = rnet[f"up_{depth - 2 - k}"]
        sd[f"RNet.up_path.{k}.upsampler.weight"] = (
            np.asarray(up["up_kernel"]).transpose(2, 3, 0, 1))
        sd[f"RNet.up_path.{k}.upsampler.bias"] = np.asarray(up["up_bias"])
        for b in range(n_res):
            _block(sd, f"RNet.up_path.{k}.body.{b}", up[f"block_{b}"])
    _conv(sd, "RNet.tail", rnet["tail"])
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in sd.items()}
