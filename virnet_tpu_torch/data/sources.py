"""Host-side image sources: load-once caches + fast patch sampling
(counterpart of virnet_tpu/data/sources.py).

The reference synthesizes training patches inside torch DataLoader workers
(cv2 imread + crop + aug per item, datasets/DenoisingDatasets.py:217-253).
Here the host only does cheap work — decode images once into a RAM cache,
then vectorized uint8 crop + dihedral aug per batch — and all noise/blur
synthesis happens on device (data/denoise_synth.py, data/sisr_synth.py).
"""

from __future__ import annotations

import concurrent.futures as cf
from pathlib import Path
from typing import List, Sequence

import numpy as np

from ..ops.augment import dihedral_np
from ..ops.color import imread


def glob_images(*dir_patterns) -> List[str]:
    """Collect image paths from (dir, glob) pairs, sorted (matching the
    reference's sorted union of dataset folders)."""
    paths: List[str] = []
    for d, pattern in dir_patterns:
        paths.extend(str(x) for x in Path(d).glob(pattern))
    return sorted(paths)


class ImageCache:
    """Decode a list of images once (parallel) and keep them as uint8 HWC."""

    def __init__(self, paths: Sequence[str], chn: str = "rgb",
                 max_workers: int = 16):
        self.paths = list(paths)
        if not self.paths:
            raise ValueError("ImageCache: empty path list")
        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            self.images = list(ex.map(
                lambda p: np.ascontiguousarray(imread(p, chn=chn,
                                                      dtype="uint8")),
                self.paths))

    def __len__(self):
        return len(self.images)


class PatchSampler:
    """Random patch batches: image pick -> crop -> dihedral aug, vectorized
    on uint8, returning float32 [0,1] NHWC (or uint8 with ``raw=True`` —
    the trainers normalize uint8 in-graph, shipping 4x less data to the
    device)."""

    def __init__(self, cache: ImageCache, patch_size: int, seed: int = 0):
        self.cache = cache
        self.patch_size = patch_size
        self.rng = np.random.default_rng(seed)

    def reset_seed(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size: int, raw: bool = False) -> np.ndarray:
        p = self.patch_size
        out = np.empty((batch_size, p, p, 3), dtype=np.uint8)
        n_im = len(self.cache)
        idx = self.rng.integers(0, n_im, size=batch_size)
        modes = self.rng.integers(0, 8, size=batch_size)
        for b in range(batch_size):
            im = self.cache.images[idx[b]]
            h, w = im.shape[:2]
            i = int(self.rng.integers(0, h - p + 1))
            j = int(self.rng.integers(0, w - p + 1))
            patch = im[i:i + p, j:j + p]
            if patch.ndim == 2:
                patch = np.stack([patch] * 3, axis=-1)
            out[b] = dihedral_np(patch, int(modes[b]))
        if raw:
            return out
        return out.astype(np.float32) / 255.0


class PairedPatchSampler:
    """Noisy/GT paired patch batches for real-data training (SIDD-style
    folders: <root>/noisy/*.png with GT at <root>/gt/<same-name>,
    reference datasets/DenoisingDatasets.py:101-155)."""

    def __init__(self, noisy_dir, patch_size: int, seed: int = 0,
                 keys: Sequence[str] = ("sidd",)):
        noisy_paths = [str(x) for x in Path(noisy_dir).glob("*.png")
                       if any(k in Path(x).stem for k in keys)] or \
                      [str(x) for x in Path(noisy_dir).glob("*.png")]
        gt_paths = [str(Path(p).parents[1] / "gt" / Path(p).name)
                    for p in noisy_paths]
        self.noisy = ImageCache(noisy_paths)
        self.gt = ImageCache(gt_paths)
        self.patch_size = patch_size
        self.rng = np.random.default_rng(seed)

    def reset_seed(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_size: int, raw: bool = False):
        p = self.patch_size
        noisy = np.empty((batch_size, p, p, 3), dtype=np.uint8)
        gt = np.empty_like(noisy)
        n_im = len(self.noisy)
        idx = self.rng.integers(0, n_im, size=batch_size)
        modes = self.rng.integers(0, 8, size=batch_size)
        for b in range(batch_size):
            im_n = self.noisy.images[idx[b]]
            im_g = self.gt.images[idx[b]]
            h, w = im_n.shape[:2]
            i = int(self.rng.integers(0, h - p + 1))
            j = int(self.rng.integers(0, w - p + 1))
            noisy[b] = dihedral_np(im_n[i:i + p, j:j + p], int(modes[b]))
            gt[b] = dihedral_np(im_g[i:i + p, j:j + p], int(modes[b]))
        if raw:
            return noisy, gt
        return (noisy.astype(np.float32) / 255.0,
                gt.astype(np.float32) / 255.0)
