"""Import of reference checkpoints (counterpart of
virnet_tpu/convert/torch_import.py).

The port's parameter names are the reference torch keys (reference
networks/DnCNN.py:22-29, networks/AttResUNet.py:11-139, networks/KNet.py:
41-59), so a released ``.pth`` loads with ``load_state_dict(strict=True)``
once ``module.`` is stripped, fp16 is cast to fp32 and any BatchNorm is
folded into its conv (``load_pth``).  ``to_jax_params`` is the JAX
package's ``convert_state_dict``: such a state dict as the flax parameter
tree of numpy arrays (conv weights OIHW -> HWIO, transposed-conv weights
IOHW -> (2, 2, I, O)), for handing the port's weights to the JAX package.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Optional

import numpy as np
import torch

from .merge_bn import find_conv_bn_pairs, merge_bn_state_dict


def load_pth(path, transposed: Optional[Collection[str]] = None
             ) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` (a bare state dict or the trainer's
    {'model_state_dict': ...} wrapper) as an fp32 state dict, with every
    conv+BN pair folded (``merge_bn``; ``transposed`` names ConvTranspose2d
    modules for it).  A state dict without BatchNorm is returned as it was
    loaded, cast to fp32."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    sd = {k.removeprefix("module."): v for k, v in ckpt.items()}
    pairs = find_conv_bn_pairs(sd)
    if pairs:
        sd = merge_bn_state_dict(sd, pairs, transposed)
    return {k: v.float() for k, v in sd.items()}


def _np(sd: Dict, key: str) -> np.ndarray:
    return np.asarray(sd[key].detach().cpu().numpy(), dtype=np.float32)


def _conv(sd: Dict, name: str, bias: bool = True) -> Dict[str, np.ndarray]:
    """torch conv -> {'kernel': HWIO, 'bias': (O,)}"""
    out = {"kernel": np.ascontiguousarray(
        _np(sd, f"{name}.weight").transpose(2, 3, 1, 0))}
    if bias:
        out["bias"] = _np(sd, f"{name}.bias")
    return out


def _block(sd: Dict, prefix: str) -> Dict[str, Any]:
    out = {"conv1": _conv(sd, f"{prefix}.conv1"),
           "conv2": _conv(sd, f"{prefix}.conv2")}
    if f"{prefix}.sft1.conv1.weight" in sd:
        for sft in ("sft1", "sft2"):
            out[sft] = {name: _conv(sd, f"{prefix}.{sft}.{name}")
                        for name in ("conv1", "conv2", "mul_conv",
                                     "add_conv")}
    return out


def _count(sd: Dict, prefix: str) -> int:
    """How many indices ``prefix.<i>.`` the keys hold."""
    return len({k[len(prefix):].split(".")[0] for k in sd
                if k.startswith(prefix)})


def to_jax_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A VIRNet or VIRNetSR state dict (the reference's keys, ``module.``
    stripped) -> {'params': the JAX package's flax tree of float32 numpy
    arrays}, leaf for leaf what virnet_tpu.convert.convert_state_dict builds
    for the same weights; the architecture is read off the keys."""
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    snet = {"conv1": _conv(sd, "SNet.conv1")}
    mids = sorted(int(i) for i in {k.split(".")[2] for k in sd
                                   if k.startswith("SNet.mid_layer.")})
    for ii, idx in enumerate(mids, start=1):
        snet[f"mid_{ii}"] = _conv(sd, f"SNet.mid_layer.{idx}")
    snet["conv_last"] = _conv(sd, "SNet.conv_last")

    depth = _count(sd, "RNet.down_path.")
    n_res = _count(sd, "RNet.down_path.0.body.")
    rnet = {"head": _conv(sd, "RNet.head"), "tail": _conv(sd, "RNet.tail")}
    for ii in range(depth):
        for jj in range(n_res):
            rnet[f"down_{ii}_block_{jj}"] = _block(
                sd, f"RNet.down_path.{ii}.body.{jj}")
        if ii + 1 < depth:
            rnet[f"down_{ii}_sampler"] = _conv(
                sd, f"RNet.down_path.{ii}.downsampler")
    for k in range(depth - 1):          # torch up_path[k] is up_{depth-2-k}
        up_prefix = f"RNet.up_path.{k}"
        up = {"up_kernel": np.ascontiguousarray(
                  _np(sd, f"{up_prefix}.upsampler.weight").transpose(
                      2, 3, 0, 1)),
              "up_bias": _np(sd, f"{up_prefix}.upsampler.bias")}
        for b in range(n_res):
            up[f"block_{b}"] = _block(sd, f"{up_prefix}.body.{b}")
        rnet[f"up_{depth - 2 - k}"] = up

    params = {"snet": snet, "rnet": rnet}
    if "KNet.head.weight" in sd:
        knet = {"head": _conv(sd, "KNet.head", bias=False),
                "tail": _conv(sd, "KNet.tail.0")}
        for ii in range(_count(sd, "KNet.body.")):
            bp = f"KNet.body.{ii}.body"
            knet[f"rb_{ii}"] = {
                "conv1": _conv(sd, f"{bp}.0"),
                "conv2": _conv(sd, f"{bp}.2"),
                "ca": {"squeeze": _conv(sd, f"{bp}.3.body.0"),
                       "excite": _conv(sd, f"{bp}.3.body.2")}}
        params["knet"] = knet
    return {"params": params}
