"""MixUp augmentation for real-noise training (counterpart of
virnet_tpu/data/mixup.py; reference datasets/data_tools.py:12-30, applied
train_denoising_real.py:163): a Beta(0.6, 0.6) mixing coefficient per
sample and a random batch permutation blend (gt, noisy) pairs consistently,
on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


@torch.no_grad()
def mixup_pairs(im_gt: torch.Tensor, im_noisy: torch.Tensor,
                alpha: float = 0.6,
                generator: Optional[torch.Generator] = None,
                draws: Optional[tuple] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gt, noisy) NHWC batches -> the mixed (gt, noisy).  ``draws`` =
    (indices (N,) a permutation, lam (N, 1, 1, 1) in (0, 1)) replaces the
    generator.  Beta(a, a) is g1 / (g1 + g2) of two Gamma(a) draws
    (``torch.distributions`` takes no generator)."""
    bs, dev = im_gt.shape[0], im_gt.device
    if draws is None:
        indices = torch.randperm(bs, generator=generator, device=dev)
        shape = torch.full((2, bs), float(alpha), dtype=im_gt.dtype,
                           device=dev)
        g = torch._standard_gamma(shape, generator=generator)
        lam = (g[0] / (g[0] + g[1])).view(bs, 1, 1, 1)
    else:
        indices, lam = draws
        lam = lam.to(im_gt.dtype).view(bs, 1, 1, 1)
    return (lam * im_gt + (1 - lam) * im_gt[indices],
            lam * im_noisy + (1 - lam) * im_noisy[indices])
