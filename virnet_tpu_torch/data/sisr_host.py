"""Host-side SISR training degradation with exact libjpeg round trips
(counterpart of virnet_tpu/data/sisr_host.py).

The device path (data/sisr_synth.py) covers the Gaussian branch and, with
``jpeg_in_graph``, a float approximation of the JPEG branch.  For the
reference's own semantics the JPEG noise needs libjpeg, so with
``add_jpeg`` and no ``jpeg_in_graph`` the degradation runs on the host
exactly like the reference's GeneralTrainFloder
(datasets/SISRDatasets.py:66-122): random anisotropic kernel ->
scipy-convolve blur -> direct/bicubic downsample -> Gaussian or JPEG
(random qf) noise.  Batches carry (hr, lr, kinfo, nlevel) ready for the
ELBO.  The numpy generator draws what the JAX sampler draws, so one seed
gives the same batches in both packages.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np

from ..ops.color import jpeg_compress
from ..ops.degrade import imconv_np
from ..ops.kernels import anisotropic_gaussian_np
from ..ops.resize import resize_np
from .sisr_synth import QF_END, QF_START
from .sources import ImageCache, PatchSampler


class HostSISRBatch(NamedTuple):
    im_hr: np.ndarray    # N x H x W x C float32
    im_lr: np.ndarray    # N x H/sf x W/sf x C float32
    kinfo: np.ndarray    # N x 3 float32
    nlevel: np.ndarray   # N x 1 float32 (noise std)


def random_qf(rng: np.random.Generator) -> int:
    """MATLAB-style JPEG quality table (reference
    datasets/SISRDatasets.py:52-60)."""
    ind = int(rng.integers(0, len(QF_START)))
    return int(rng.integers(QF_START[ind], QF_END[ind] + 1))


class HostSISRSampler:
    """HR patch batches degraded on the host (JPEG-capable)."""

    def __init__(self, cache: ImageCache, hr_size: int, sf: int,
                 k_size: int = 21, kernel_shift: bool = False,
                 downsampler: str = "bicubic",
                 noise_level: Sequence[float] = (0.1, 15.0),
                 noise_jpeg: Sequence[float] = (0.1, 10.0),
                 add_jpeg: bool = True, seed: int = 0):
        self.patch = PatchSampler(cache, hr_size, seed)
        self.sf = sf
        self.k_size = k_size
        self.kernel_shift = kernel_shift
        self.downsampler = downsampler.lower()
        self.noise_level = noise_level
        self.noise_jpeg = noise_jpeg
        self.noise_types = ["Gaussian"] + (["JPEG"] if add_jpeg else [])
        self.rng = np.random.default_rng(seed)

    def reset_seed(self, seed: int):
        self.patch.reset_seed(seed)
        self.rng = np.random.default_rng(seed + 1)

    def _degrade(self, hr: np.ndarray):
        """One HR patch -> (LR, kinfo, noise std)."""
        sf = self.sf
        lam1 = self.rng.uniform(0.2, sf)
        lam2 = self.rng.uniform(lam1, sf) if self.rng.random() < 0.7 else lam1
        theta = self.rng.uniform(0, np.pi)
        kernel, kinfo = anisotropic_gaussian_np(
            k_size=self.k_size, sf=sf, lambda_1=lam1 ** 2,
            lambda_2=lam2 ** 2, theta=theta, shift=self.kernel_shift)
        blur = np.clip(imconv_np(hr, kernel, padding_mode="reflect",
                                 correlate=False), 0.0, 1.0)
        if self.downsampler == "direct":
            down = blur[::sf, ::sf]
        else:
            down = resize_np(blur, scale_factors=1 / sf).astype(np.float32)

        noise_type = self.noise_types[
            int(self.rng.integers(0, len(self.noise_types)))]
        if noise_type == "Gaussian":
            std = self.rng.uniform(*self.noise_level) / 255.0
            return np.clip(down + self.rng.standard_normal(down.shape).astype(
                np.float32) * std, 0.0, 1.0), kinfo, std
        qf = random_qf(self.rng)
        std = self.rng.uniform(*self.noise_jpeg) / 255.0
        noisy = np.clip(down + self.rng.standard_normal(down.shape).astype(
            np.float32) * std, 0.0, 1.0)
        return (jpeg_compress(noisy.astype(np.float32), qf, chn_in="rgb"),
                kinfo, std)

    def sample(self, batch_size: int) -> HostSISRBatch:
        hr = self.patch.sample(batch_size)          # N,H,W,3 float32
        lr_size = math.ceil(hr.shape[1] / self.sf)
        lr = np.empty((batch_size, lr_size, lr_size, 3), dtype=np.float32)
        kinfos = np.empty((batch_size, 3), dtype=np.float32)
        nlevels = np.empty((batch_size, 1), dtype=np.float32)
        for b in range(batch_size):
            lr[b], kinfos[b], nlevels[b] = self._degrade(hr[b])
        return HostSISRBatch(im_hr=hr, im_lr=lr, kinfo=kinfos,
                             nlevel=nlevels)
