"""Seeded evaluation datasets (counterpart of virnet_tpu/data/eval_sets.py;
the reference's deterministic eval pipelines).

Host-side numpy: the fixed seeds (1000/1234/10000) reproduce the
reference's noise fields exactly, so PSNR/SSIM goldens are comparable.
np.random.default_rng is PCG64 in both code bases; the SISR fixed noise is
drawn from a torch CPU Generator, as the reference does
(datasets/SISRDatasets.py:160-162).  Images are read and sigma maps resized
with cv2, imported where it is used.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from ..ops.color import imread, jpeg_compress
from ..ops.degrade import imconv_np
from ..ops.kernels import anisotropic_gaussian_np
from ..ops.pad import modcrop
from ..ops.resize import resize_np
from ..ops.sigma_fields import (gauss_kernel_mix, peaks, rescale_field,
                                sincos_kernel)


# ---------------------------------------------------------------------------
# Denoising: in-training validation set (reference SimulateTest,
# datasets/DenoisingDatasets.py:255-296)
# ---------------------------------------------------------------------------

class DenoiseValSet:
    """Fixed rng(seed) noise field sized to the largest image; sigma-map from
    peaks(256) rescaled to [10, 75]/255, nearest-resized per image."""

    def __init__(self, im_paths: List[str], seed: int = 1000):
        self.im_paths = list(im_paths)
        h_max = w_max = 1
        for p in self.im_paths:
            im = imread(p, chn="bgr", dtype="uint8")
            h_max = max(h_max, im.shape[0])
            w_max = max(w_max, im.shape[1])
        rng = np.random.default_rng(seed=seed)
        self.noise = rng.standard_normal(size=[h_max, w_max, 3],
                                         dtype=np.float32)
        self.sigma_map = rescale_field(peaks(256), 10 / 255.0, 75 / 255.0)

    def __len__(self):
        return len(self.im_paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        import cv2

        im_gt = imread(self.im_paths[idx], chn="rgb", dtype="float32")
        h, w = im_gt.shape[:2]
        sigma = cv2.resize(self.sigma_map, (w, h),
                           interpolation=cv2.INTER_NEAREST_EXACT)
        im_noisy = im_gt + self.noise[:h, :w] * sigma[:, :, None]
        return im_noisy.astype(np.float32), im_gt

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


# ---------------------------------------------------------------------------
# Denoising: Table 1/2 benchmark cases (reference
# scripts/denoising_virnet_syn.py:92-108)
# ---------------------------------------------------------------------------

NIID_CASES = ("peaks", "sincos", "gauss_mix")
IID_SIGMAS = (15, 25, 50)


class DenoiseBenchmark:
    """Table 1/2 noisy synthesis, bit-compatible with the reference script's
    single seeded RNG stream: all three niid base fields are built up front
    (gauss_mix consumes the stream once), then per-image noise draws continue
    from the same stream in float64."""

    def __init__(self, noise_type: str = "niid", seed: int = 1000):
        self.noise_type = noise_type.lower()
        self.rng = np.random.default_rng(seed=seed)
        if self.noise_type == "niid":
            self.base_fields = [("peaks", peaks(256)),
                                ("sincos", sincos_kernel()),
                                ("gauss_mix",
                                 gauss_kernel_mix(256, 256, self.rng))]
        elif self.noise_type == "iid":
            self.base_fields = [(str(s), s) for s in IID_SIGMAS]
        else:
            raise ValueError("noise_type must be 'niid' or 'iid'")

    def cases(self):
        return list(self.base_fields)

    def sigma_for(self, base, h: int, w: int) -> np.ndarray:
        import cv2

        if self.noise_type == "niid":
            field = rescale_field(base, 10 / 255.0, 75 / 255.0)
            return cv2.resize(field, (w, h),
                              interpolation=cv2.INTER_NEAREST_EXACT
                              ).astype(np.float32)
        return np.ones([h, w], dtype=np.float32) * (float(base) / 255.0)

    def noisy(self, im_gt_uint8: np.ndarray, base) -> np.ndarray:
        """uint8 HWC GT -> float32 noisy image (GT/255 + N(0, sigma))."""
        h, w = im_gt_uint8.shape[:2]
        sigma = self.sigma_for(base, h, w)
        noise = self.rng.standard_normal(size=im_gt_uint8.shape) \
            * sigma[:, :, np.newaxis]
        gt = (im_gt_uint8 / 255.0).astype(np.float32)
        return gt + noise.astype(np.float32)


# ---------------------------------------------------------------------------
# SISR: validation + Table 5 (reference GeneralTest,
# datasets/SISRDatasets.py:124-207 and scripts/sisr_virnet_syn.py:104-141)
# ---------------------------------------------------------------------------

class SISRValSet:
    """Fixed iso kernel lambda=1.6², fixed torch-Generator noise (seed 10000),
    modcrop, Gaussian(2.55/255) or JPEG(qf 40)."""

    def __init__(self, hr_paths: List[str], sf: int, k_size: int = 21,
                 kernel_shift: bool = False, downsampler: str = "bicubic",
                 seed: int = 10000, noise_type: str = "Gaussian"):
        self.hr_paths = list(hr_paths)
        self.sf = sf
        self.k_size = k_size
        self.kernel_shift = kernel_shift
        self.downsampler = downsampler
        self.noise_type = noise_type

        h_max = w_max = 1
        for p in self.hr_paths:
            im = imread(p, chn="bgr", dtype="uint8")
            h_max = max(h_max, im.shape[0])
            w_max = max(w_max, im.shape[1])
        g = torch.Generator()
        g.manual_seed(seed)
        self.fixed_noise = torch.randn(
            [math.ceil(h_max / sf), math.ceil(w_max / sf), 3],
            generator=g, dtype=torch.float32).numpy()

    def __len__(self):
        return len(self.hr_paths)

    def __getitem__(self, idx: int):
        im_hr = imread(self.hr_paths[idx], chn="rgb", dtype="float32")
        if im_hr.ndim == 2 or im_hr.shape[2] == 1:
            im_hr = np.stack([np.squeeze(im_hr)] * 3, axis=2)
        im_hr = modcrop(im_hr, self.sf)

        kernel, kinfo = anisotropic_gaussian_np(
            k_size=self.k_size, sf=self.sf, lambda_1=1.6 ** 2,
            lambda_2=1.6 ** 2, theta=0, shift=self.kernel_shift)

        im_blur = imconv_np(im_hr, kernel, padding_mode="reflect",
                            correlate=False)
        im_blur = np.clip(im_blur, 0.0, 1.0)
        if self.downsampler.lower() == "direct":
            im_blur = im_blur[::self.sf, ::self.sf]
        else:
            im_blur = resize_np(im_blur, scale_factors=1 / self.sf)

        h, w = im_blur.shape[:2]
        noisy = im_blur + self.fixed_noise[:h, :w] * (2.55 / 255)
        noisy = np.clip(noisy, 0.0, 1.0).astype(np.float32)
        if self.noise_type == "JPEG":
            noisy = jpeg_compress(noisy, 40, chn_in="rgb")
        return im_hr.astype(np.float32), noisy, kinfo.astype(np.float32)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def table5_kernels(sf: int, k_size: int = 21,
                   shift: bool = False) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The 7 fixed eval kernels per scale factor (reference
    scripts/sisr_virnet_syn.py:104-118): three isotropic with lambda = 0.4/0.6/0.8
    of sf, and four anisotropic (lambda1, lambda2, θ) combos; all unshifted."""
    cases = [
        (0.40 * sf, 0.40 * sf, 0.0),
        (0.60 * sf, 0.60 * sf, 0.0),
        (0.80 * sf, 0.80 * sf, 0.0),
        (0.40 * sf, 0.20 * sf, 0.0),
        (0.60 * sf, 0.30 * sf, 0.75 * np.pi),
        (0.80 * sf, 0.40 * sf, 0.25 * np.pi),
        (0.80 * sf, 0.40 * sf, 0.50 * np.pi),
    ]
    out = []
    for l1, l2, th in cases:
        kernel, kinfo = anisotropic_gaussian_np(
            k_size=k_size, sf=sf, lambda_1=l1 ** 2, lambda_2=l2 ** 2,
            theta=th, shift=shift)
        out.append((kernel.astype(np.float32), kinfo.astype(np.float32)))
    return out
