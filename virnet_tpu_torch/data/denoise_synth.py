"""On-device synthetic-noise generation for denoising training
(counterpart of virnet_tpu/data/denoise_synth.py; reference
datasets/DenoisingDatasets.py:190-253): the per-sample sigma maps and the
noise fields of a whole batch are made on the card, under ``no_grad``.

Per sample (mode='niid'):
  center ~ U(0, p)^2, scale ~ U(p/4, 3p/4)
  bump(i, j) = exp(-((i-ch)^2 + (j-cw)^2) / (2 scale^2))
  up, down ~ U(0, 75/255) (swapped so up >= down), up += 5/255
  sigma map = down + normalize01(bump) * (up - down)
mode='iid': a single sigma ~ U(0, 75/255) per sample.
Noise: eps ~ N(0, 1) * sigma map; the sigma^2 map is clamped at 1e-10.

Every draw takes a ``torch.Generator`` or the drawn tensors themselves
(``draws``), so a test can hand this package and the JAX package the same
numbers.  On the CPU exp goes through float64 (see
ops/fused_conv.exp_clip).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SIGMA_MAX = 75.0 / 255.0


def _uniform(shape, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def _exp(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return torch.exp(x.double()).to(x.dtype)
    return torch.exp(x)


def sigma_draws(batch: int, patch: int, mode: str = "niid",
                generator: Optional[torch.Generator] = None,
                device="cpu") -> dict:
    """The draws of a batch's sigma maps, in the generator's order:
    'niid' center (N, 2), scale (N, 1, 1) and updown (N, 2); 'iid' level
    (N, 1, 1, 1)."""
    if mode == "iid":
        return dict(level=_uniform((batch, 1, 1, 1), 0.0, SIGMA_MAX,
                                   generator, device))
    if mode != "niid":
        raise ValueError("mode must be 'niid' or 'iid'")
    return dict(
        center=_uniform((batch, 2), 0.0, float(patch), generator, device),
        scale=_uniform((batch, 1, 1), patch / 4, patch / 4 * 3, generator,
                       device),
        updown=_uniform((batch, 2), 0.0, SIGMA_MAX, generator, device))


def noisy_batch_draws(shape, mode: str = "niid",
                      generator: Optional[torch.Generator] = None,
                      device="cpu", dtype=torch.float32) -> dict:
    """Every draw of ``synthesize_noisy_batch`` on a GT batch of ``shape``
    (N, p, p, C), in the generator's order: ``sigma_draws`` and then
    ``eps``.  A data-parallel rank draws the global batch's and keeps its
    rows."""
    draws = sigma_draws(shape[0], shape[1], mode, generator, device)
    draws["eps"] = torch.randn(tuple(shape), generator=generator,
                               dtype=dtype, device=device)
    return draws


def generate_sigma_niid(batch: int, patch: int,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[dict] = None,
                        device="cpu") -> torch.Tensor:
    """(N, p, p, 1) Gaussian-bump sigma maps.  ``draws``: dict(center (N,
    2) in [0, p), scale (N, 1, 1) in [p/4, 3p/4), updown (N, 2) in [0,
    75/255)) in place of the generator."""
    if draws is None:
        draws = sigma_draws(batch, patch, "niid", generator, device)
    center, scale, ud = draws["center"], draws["scale"], draws["updown"]
    up = torch.maximum(ud[:, 0], ud[:, 1]) + 5.0 / 255.0
    down = torch.minimum(ud[:, 0], ud[:, 1])

    ii = torch.arange(patch, dtype=torch.float32,
                      device=center.device)[None, :, None]
    jj = torch.arange(patch, dtype=torch.float32,
                      device=center.device)[None, None, :]
    ch = center[:, 0][:, None, None]
    cw = center[:, 1][:, None, None]
    bump = _exp((-(ii - ch) ** 2 - (jj - cw) ** 2) / (2 * scale ** 2))

    lo = bump.amin(dim=(1, 2), keepdim=True)
    hi = bump.amax(dim=(1, 2), keepdim=True)
    norm = (bump - lo) / (hi - lo)
    sigma = down[:, None, None] + norm * (up - down)[:, None, None]
    return sigma[..., None]                                    # N x p x p x 1


def generate_sigma_iid(batch: int, patch: int,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[dict] = None,
                       device="cpu") -> torch.Tensor:
    """(N, p, p, 1) constant sigma maps.  ``draws``: dict(level (N, 1, 1,
    1) in [0, 75/255))."""
    if draws is None:
        draws = sigma_draws(batch, patch, "iid", generator, device)
    level = draws["level"]
    return level.expand(batch, patch, patch, 1)


@torch.no_grad()
def synthesize_noisy_batch(im_gt: torch.Tensor, mode: str = "niid",
                           clip: bool = False,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[dict] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GT batch (N, p, p, C) float32 -> (noisy batch, sigma^2 map (N, p, p,
    1) clamped), on the device of ``im_gt``.  ``draws`` holds the draws of
    the sigma map (see ``generate_sigma_niid`` / ``generate_sigma_iid``)
    plus ``eps``, standard normals of im_gt's shape."""
    batch, patch = im_gt.shape[0], im_gt.shape[1]
    if draws is None:
        draws = noisy_batch_draws(im_gt.shape, mode, generator, im_gt.device,
                                  im_gt.dtype)
    if mode == "niid":
        sigma = generate_sigma_niid(batch, patch, generator, draws,
                                    im_gt.device)
    elif mode == "iid":
        sigma = generate_sigma_iid(batch, patch, generator, draws,
                                   im_gt.device)
    else:
        raise ValueError("mode must be 'niid' or 'iid'")
    im_noisy = im_gt + draws["eps"] * sigma
    if clip:
        im_noisy = im_noisy.clamp(0.0, 1.0)
    return im_noisy, (sigma ** 2).clamp_min(1e-10)
