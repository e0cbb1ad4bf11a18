"""MixUp augmentation for real-noise training (counterpart of
virnet_tpu/data/mixup.py; reference datasets/data_tools.py:12-30, applied
train_denoising_real.py:163): a Beta(0.6, 0.6) mixing coefficient per
sample and a random batch permutation blend (gt, noisy) pairs consistently,
on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def mixup_draws(bs: int, alpha: float = 0.6,
                generator: Optional[torch.Generator] = None, device="cpu",
                dtype=torch.float32) -> tuple:
    """The draws of ``mixup_pairs``, in the generator's order: a
    permutation of the batch (N,) and the coefficients lam (N, 1, 1, 1),
    Beta(alpha, alpha) as g1 / (g1 + g2) of two Gamma(alpha) draws
    (``torch.distributions`` takes no generator)."""
    indices = torch.randperm(bs, generator=generator, device=device)
    shape = torch.full((2, bs), float(alpha), dtype=dtype, device=device)
    g = torch._standard_gamma(shape, generator=generator)
    return indices, (g[0] / (g[0] + g[1])).view(bs, 1, 1, 1)


@torch.no_grad()
def mixup_pairs(im_gt: torch.Tensor, im_noisy: torch.Tensor,
                alpha: float = 0.6,
                generator: Optional[torch.Generator] = None,
                draws: Optional[tuple] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gt, noisy) NHWC batches -> the mixed (gt, noisy).  ``draws`` =
    (indices (N,) a permutation, lam (N, 1, 1, 1) in (0, 1)) replaces the
    generator (``mixup_draws``).  The pairs of a row come from anywhere in
    the batch, so a data-parallel rank mixes the global batch and keeps
    its rows."""
    bs = im_gt.shape[0]
    if draws is None:
        draws = mixup_draws(bs, alpha, generator, im_gt.device, im_gt.dtype)
    indices, lam = draws
    lam = lam.to(im_gt.dtype).view(bs, 1, 1, 1)
    return (lam * im_gt + (1 - lam) * im_gt[indices],
            lam * im_noisy + (1 - lam) * im_noisy[indices])
