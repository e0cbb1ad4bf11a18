"""The x8 flip/rotation self-ensemble on the device (counterpart of
virnet_tpu/eval/tta.py).

The reference runs the 8 dihedral orientations one after another per block
(scripts/denoising_virnet_real_sidd.py:121-136).  Here they go into the
batch axis and through ONE forward call, and are inverse-mapped and
averaged where the forward's output lies.  Square inputs only (every
caller's: 256^2 SIDD blocks, 512^2 DND crops); ``Restorer.restore_image_tta``
is the host ensemble for any shape.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.augment import dihedral_stack, dihedral_unstack_mean


def tta_x8(forward: Callable[[torch.Tensor], torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """forward: NHWC -> NHWC restore function; x: (N, H, W, C), H == W.
    Returns the mean of the 8 inverse-mapped orientation outputs."""
    n, h, w, c = x.shape
    if h != w:
        raise ValueError(f"x8 TTA needs square inputs, got {h}x{w}")
    out = forward(dihedral_stack(x).reshape(8 * n, h, w, c))
    return dihedral_unstack_mean(out.reshape(8, n, h, w, out.shape[-1]))
