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

from ..ops.qconv import conv_w8a8
from ..precision import im2col_on, int8_dtype


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


def int8_gated(m: nn.Module) -> bool:
    """Whether the int8 mode quantizes ``m``: a Conv2d of stride 1 and
    padding k // 2 whose input and output widths are both at least 16 (the
    JAX package's gate, virnet_tpu/models/common.py:conv).  The narrow
    convs (the sigma heads on [x | sqrt(sigma)], the 3-channel tails, the
    channel-attention squeeze) and the strided ones stay in float."""
    if type(m) is not nn.Conv2d:
        return False
    k = m.kernel_size[0]
    return (m.kernel_size == (k, k) and m.stride == (1, 1)
            and m.padding == (k // 2, k // 2) and m.groups == 1
            and m.dilation == (1, 1)
            and min(m.in_channels, m.out_channels) >= 16)


def cast_for_int8(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast ``model``'s parameters to ``dtype`` in place, except those of
    the convs that the int8 gate takes: they stay float32, the weights the
    JAX package quantizes (its QuantConv reads the float32 parameters)."""
    for m in model.modules():
        if int8_gated(m):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return model


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``m`` to ``x`` in the weights' dtype (the compute dtype), on
    the im2col route inside ``precision.im2col_convs``; inside
    ``precision.int8_convs`` a conv that the int8 gate takes runs W8A8
    (ops/qconv.conv_w8a8: K9 on the card) on ``x`` as it comes, from its
    float32 weights, and writes the mode's dtype."""
    out_dtype = int8_dtype()
    if out_dtype is not None and int8_gated(m):
        y = conv_w8a8(to_nhwc(x), conv_hwio(m), m.bias,
                      out_dtype=out_dtype)
        return to_nchw(y)
    x = x.to(m.weight.dtype)
    if im2col_on():
        return torch.ops.aten.thnn_conv2d(x, m.weight, m.kernel_size, m.bias,
                                          m.stride, m.padding)
    return F.conv2d(x, m.weight, m.bias, m.stride, m.padding)


def lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def hwio(w: torch.Tensor) -> torch.Tensor:
    """torch OIHW conv weight -> contiguous HWIO (the kernels' layout)."""
    return w.permute(2, 3, 1, 0).contiguous()


def kernel_layout(module: nn.Module, build, key: str = "_kernel_layout"):
    """``build(module)``, the module's weights in the kernels' layout,
    cached on the module under ``key`` (one key a layout).  The cache holds
    on to the parameters' storage and version counters, so it is rebuilt
    when a parameter is moved, cast, loaded or updated in place.  While
    autograd records, it is built anew every call and stays attached to
    the parameters, so that a forward-only kernel handed it sees that they
    require grad and raises."""
    params = list(module.parameters())
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return build(module)
    hit = module.__dict__.get(key)
    if hit is not None and len(hit[0]) == len(params) and all(
            p.data_ptr() == s.data_ptr() and p._version == v
            for p, (s, v) in zip(params, hit[0])):
        return hit[1]
    with torch.no_grad():
        out = build(module)
    module.__dict__[key] = (
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
