"""Batched PSNR/SSIM on the device (counterpart of
virnet_tpu/eval/metrics_device.py), the MATLAB protocol of the host scorers
(eval/metrics.py) on NHWC float tensors: one call per batch instead of a
host round trip per image (SIDD's 1280 blocks).

  * the uint8 round trip emulated with round-half-to-even (torch.round);
  * the 11x11 sigma=1.5 Gaussian window as a depthwise F.conv2d, kept on
    the 5-px valid crop: the reference pads by reflection and crops the
    same 5 px, so no value kept reads the pad, and the port filters the
    'valid' region alone;
  * optional Y channel and border crop.

fp32 with TF32 off (``precision.parity_mode``).  Agreement with the host
scorers is ~1e-4 dB / 1e-6 SSIM (fp32 against fp64).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.color import rgb2ycbcr
from ..precision import parity_mode
from .metrics import _SSIM_C1, _SSIM_C2, _ssim_window


def quantize_uint8(x: torch.Tensor) -> torch.Tensor:
    """The img_as_ubyte round trip in float: clip, *255, round half to
    even, clip."""
    return torch.clamp(torch.round(torch.clamp(x, 0.0, 1.0) * 255.0),
                       0.0, 255.0)


def _filter11(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> the window's 'valid' correlation, (N, H-10, W-10, C)
    (cv2.filter2D's map after the reference's [5:-5, 5:-5] crop)."""
    c = x.shape[-1]
    win = torch.as_tensor(_ssim_window(), dtype=x.dtype, device=x.device)
    out = F.conv2d(x.permute(0, 3, 1, 2), win.expand(c, 1, 11, 11),
                   groups=c)
    return out.permute(0, 2, 3, 1)


def _prepare(img, clean, border: int, ycbcr: bool):
    a = quantize_uint8(img.float())
    b = quantize_uint8(clean.float())
    if ycbcr:
        a = quantize_uint8(rgb2ycbcr(a / 255.0, True))
        b = quantize_uint8(rgb2ycbcr(b / 255.0, True))
    if border > 0:
        a = a[:, border:-border, border:-border]
        b = b[:, border:-border, border:-border]
    return a, b


def batch_psnr_device(img: torch.Tensor, clean: torch.Tensor,
                      border: int = 0, ycbcr: bool = False) -> torch.Tensor:
    """(N, H, W, C) float [0, 1] -> (N,) PSNR after the uint8 round trip."""
    with parity_mode():
        a, b = _prepare(img, clean, border, ycbcr)
        mse = torch.mean((a - b) ** 2, dim=(1, 2, 3))
        return 20.0 * torch.log10(255.0 / torch.sqrt(mse))


def batch_ssim_device(img: torch.Tensor, clean: torch.Tensor,
                      border: int = 0, ycbcr: bool = False) -> torch.Tensor:
    """(N, H, W, C) float [0, 1] -> (N,) MATLAB-equivalent SSIM (the mean
    over the map and the channels)."""
    with parity_mode():
        a, b = _prepare(img, clean, border, ycbcr)
        mu1, mu2 = _filter11(a), _filter11(b)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
        sigma1_sq = _filter11(a * a) - mu1_sq
        sigma2_sq = _filter11(b * b) - mu2_sq
        sigma12 = _filter11(a * b) - mu1_mu2
        ssim_map = ((2 * mu1_mu2 + _SSIM_C1) * (2 * sigma12 + _SSIM_C2)) / (
            (mu1_sq + mu2_sq + _SSIM_C1) * (sigma1_sq + sigma2_sq + _SSIM_C2))
        return torch.mean(ssim_map, dim=(1, 2, 3))
