"""Shared building blocks (counterpart of virnet_tpu/models/common.py).

Tensors inside the models are NCHW in shape and channels_last in memory,
so a permute to NHWC is a free view that the kernels take as it is.
Initializers replicate the ones the JAX package uses:
  * plain convs: U(+-1/sqrt(fan_in)) for kernel and bias (torch default);
  * DnCNN convs: orthogonal with leaky-relu(0.25) gain, zero bias
    (reference networks/DnCNN.py:46-52).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def torch_default_init_(weight: torch.Tensor, bias: torch.Tensor | None,
                        fan_in: int) -> None:
    """U(+-1/sqrt(fan_in)) for kernel and bias — virnet_tpu's
    ``torch_kernel_init`` / ``make_torch_bias_init``."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound)
        if bias is not None:
            bias.uniform_(-bound, bound)


def leaky_relu_gain(negative_slope: float) -> float:
    """torch nn.init.calculate_gain('leaky_relu', slope)."""
    return math.sqrt(2.0 / (1.0 + negative_slope ** 2))


def orthogonal_gain_init_(conv: nn.Conv2d, gain: float) -> None:
    with torch.no_grad():
        nn.init.orthogonal_(conv.weight, gain=gain)
        conv.bias.zero_()


def make_conv(in_chn: int, out_chn: int, kernel: int,
              stride: int = 1) -> nn.Conv2d:
    """Conv2d with torch-style integer padding kernel//2 and the JAX
    package's torch-default init."""
    m = nn.Conv2d(in_chn, out_chn, kernel, stride=stride,
                  padding=kernel // 2)
    torch_default_init_(m.weight, m.bias, kernel * kernel * in_chn)
    return m


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``m`` to ``x`` in the weights' dtype (the compute dtype)."""
    return F.conv2d(x.to(m.weight.dtype), m.weight, m.bias, m.stride,
                    m.padding)


def lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def hwio(w: torch.Tensor) -> torch.Tensor:
    """torch OIHW conv weight -> contiguous HWIO (the kernels' layout)."""
    return w.permute(2, 3, 1, 0).contiguous()


def kernel_layout(module: nn.Module, build):
    """``build(module)``, the module's weights in the kernels' layout,
    cached on the module.  The cache holds on to the parameters' storage
    and version counters, so it is rebuilt when a parameter is moved, cast,
    loaded or updated in place.  While autograd records, it is built anew
    every call so that gradients reach the parameters."""
    params = list(module.parameters())
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return build(module)
    hit = module.__dict__.get("_kernel_layout")
    if hit is not None and len(hit[0]) == len(params) and all(
            p.data_ptr() == s.data_ptr() and p._version == v
            for p, (s, v) in zip(params, hit[0])):
        return hit[1]
    with torch.no_grad():
        out = build(module)
    module.__dict__["_kernel_layout"] = (
        [(p.detach(), p._version) for p in params], out)
    return out


def conv_hwio(m: nn.Conv2d) -> torch.Tensor:
    """``m``'s weight in HWIO, cached (``kernel_layout``)."""
    return kernel_layout(m, lambda mod: hwio(mod.weight))


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW-shaped tensor -> contiguous NHWC (a view when ``x`` is
    channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW-shaped channels_last view."""
    return x.permute(0, 3, 1, 2)
