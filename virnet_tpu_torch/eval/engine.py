"""Inference engine for the denoising tasks (counterpart of
virnet_tpu/eval/engine.py:Restorer).

The forward is the model's own: K3 + RNet + K4 on shapes that pass the
fused-head gate, K2 + RNet + K4 on the others (models/virnet.py).  The
JAX engine's mesh, rows_shard and int8 paths are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import load_pth
from ..models import ARCH_PRESETS, build_model
from ..ops.augment import dihedral_inverse_np, dihedral_np
from ..ops.pad import pad_bottom_right
from ..precision import compute_dtype, resolve_device, set_parity_mode
from .tiling import bucket_size, forward_chop

CHOP_THRESHOLD = 160000   # pixels; above this, quadrant tiling kicks in


class Restorer:
    """Denoising inference on HWC float32 numpy images, with the weights
    of a reference ``.pth`` (``ckpt_path``).

    ``compute='fp32'`` is the checkpoint-faithful parity mode (TF32 off);
    ``'bf16'`` runs bf16 weights and activations with an fp32 image in and
    out.  ``pad_multiple=0`` feeds the model the raw image (the
    reference's semantics); > 0 reflect-pads to size buckets first.
    ``gray_mean=True`` averages a gray input's 3-channel restoration back
    to one channel.  ``device`` defaults to the card; the CPU runs the
    kernels' plain versions and must be asked for.  Extra keyword
    arguments go to ``build_model`` (e.g. ``conv_impl='ops'``)."""

    def __init__(self, task: str, ckpt_path, pad_multiple: int = 0,
                 gray_mean: bool = False,
                 compute: str = "fp32", device="cuda", **model_overrides):
        if task not in ARCH_PRESETS:
            raise ValueError(f"task must be one of {sorted(ARCH_PRESETS)}, "
                             f"got {task!r}")
        self.device = resolve_device(device)
        dtype = compute_dtype(compute)
        if self.device.type == "cuda":
            set_parity_mode()
        self.task = task
        self.compute = compute
        self.pad_multiple = pad_multiple
        self.gray_mean = gray_mean
        model = build_model(task, **model_overrides)
        model.load_state_dict(load_pth(ckpt_path), strict=True)
        self.model = model.to(self.device, dtype).eval()

    def restore_batch(self, x) -> torch.Tensor:
        """NHWC float32 batch (numpy or tensor) -> restored NHWC float32
        tensor on the engine's device, clamped to [0, 1]."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            mu, _ = self.model(x.contiguous())
        return torch.clamp(mu.float(), 0.0, 1.0)

    def _restore_padded(self, batch: np.ndarray) -> np.ndarray:
        """Restore an NHWC numpy batch at its bucket size, cropped back."""
        h, w = batch.shape[1:3]
        hb = bucket_size(h, self.pad_multiple)
        wb = bucket_size(w, self.pad_multiple)
        if hb != h or wb != w:
            batch = np.pad(batch, ((0, 0), (0, hb - h), (0, wb - w), (0, 0)),
                           mode="reflect")
        return self.restore_batch(batch)[:, :h, :w].cpu().numpy()

    def restore_image(self, im: np.ndarray) -> np.ndarray:
        """HWC float32 [0, 1] -> restored HWC.  Gray inputs are stacked to
        3 channels; images above ``CHOP_THRESHOLD`` pixels run through
        overlap-shave quadrant tiling."""
        squeeze_gray = im.ndim == 2
        if squeeze_gray:
            im = np.stack([im] * 3, axis=2)
        h, w = im.shape[:2]
        if h * w > CHOP_THRESHOLD:
            def fwd(x):
                hh, ww = x.shape[1], x.shape[2]
                x = pad_bottom_right(x, bucket_size(hh, self.pad_multiple),
                                     bucket_size(ww, self.pad_multiple))
                return self.restore_batch(x)[:, :hh, :ww]

            x = torch.as_tensor(im[None], dtype=torch.float32).to(self.device)
            out = forward_chop(fwd, x, shave=10,
                               min_size=CHOP_THRESHOLD)[0].cpu().numpy()
        else:
            out = self._restore_padded(im[None])[0]
        if squeeze_gray and self.gray_mean:
            out = out.mean(axis=2)
        return out

    def restore_image_tta(self, im: np.ndarray) -> np.ndarray:
        """x8 flip/rotation self-ensemble of restore_image, the
        orientations batched per shape (one forward for square images,
        two for rectangular ones)."""
        squeeze_gray = im.ndim == 2
        im3 = np.stack([im] * 3, axis=2) if squeeze_gray else im
        h, w = im3.shape[:2]
        if h * w > CHOP_THRESHOLD:
            outs = [dihedral_inverse_np(
                self.restore_image(dihedral_np(im3, m)), m)
                for m in range(8)]
        else:
            oriented = [dihedral_np(im3, m) for m in range(8)]
            outs: list = [None] * 8
            for shape in dict.fromkeys(o.shape[:2] for o in oriented):
                modes = [m for m in range(8) if oriented[m].shape[:2] == shape]
                y = self._restore_padded(np.stack([oriented[m]
                                                   for m in modes]))
                for m, o in zip(modes, y):
                    outs[m] = dihedral_inverse_np(o, m)
        out = np.mean(outs, axis=0).astype(np.float32)
        if squeeze_gray and self.gray_mean:
            out = out.mean(axis=2)
        return out

    def restore_images(self, ims, batch_size: int = 8):
        """Restore a list of HWC float32 images, grouping same-shape images
        into batched forwards.  Returns outputs in input order."""
        outs: list = [None] * len(ims)
        groups: dict = {}
        for i, im in enumerate(ims):
            im3 = np.stack([im] * 3, axis=2) if im.ndim == 2 else im
            h, w = im3.shape[:2]
            if h * w > CHOP_THRESHOLD:
                outs[i] = self.restore_image(im)
            else:
                groups.setdefault((h, w), []).append((i, im3, im.ndim == 2))
        for group in groups.values():
            for s in range(0, len(group), batch_size):
                sub = group[s:s + batch_size]
                y = self._restore_padded(np.stack([g[1] for g in sub]))
                for (i, _, was_gray), o in zip(sub, y):
                    outs[i] = (o.mean(axis=2)
                               if was_gray and self.gray_mean else o)
        return outs
