"""Device-resident datasets (counterpart of virnet_tpu/data/device_data.py):
the patch corpus lives in the card's memory, and batch assembly (record
pick, random crop, dihedral augmentation) runs on the card inside the
training step.

The reference feeds training from host DataLoader workers that crop and
augment on the CPU and copy every batch over (datasets/
DenoisingDatasets.py:73-99).  Here the uint8 patch records are copied to
the card once; each step then draws B records, B crop offsets and B
dihedral modes from the step's generator and assembles the batch with one
gather.  Per step the host sends no input bytes.

Sampling follows the reference's distribution (uniform record, uniform
crop offset, uniform mode 0..7) without matching its host RNG; the draws
come from the trainer's per-(epoch, step) generator, so runs are
reproducible and resume exactly.  One copy lives on the one card; corpora
larger than the card's memory swap chunks in with ``refresh`` between
epochs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..precision import resolve_device


def _dihedral_index(mode: torch.Tensor, p: int):
    """The source (row, col) in a p x p crop of each output pixel under
    dihedral ``mode`` ((N,) -> two (N, p, p) index tensors).  The mode is
    applied as ``dihedral_traced`` decomposes it: rot180 if mode // 2 >= 2,
    then rot90 clockwise if mode // 2 is odd, then flipud if mode is odd;
    the source index runs those steps backwards."""
    m = mode.view(-1, 1, 1)
    ar = torch.arange(p, device=mode.device)
    i, j = ar.view(1, p, 1).expand(m.shape[0], p, p), ar.view(1, 1, p)
    j = j.expand_as(i)
    i = torch.where(m % 2 == 1, p - 1 - i, i)                   # flipud
    i, j = (torch.where((m // 2) % 2 == 1, p - 1 - j, i),       # rot90 cw
            torch.where((m // 2) % 2 == 1, i, j))
    rot180 = m // 2 >= 2
    return (torch.where(rot180, p - 1 - i, i),
            torch.where(rot180, p - 1 - j, j))


def dihedral_traced(x: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """Dihedral mode 0..7 of each square (N, P, P, C) image, with a
    per-sample (N,) mode tensor on the device (the one-mode twin is
    ops/augment.dihedral, tensor semantics: rotations are clockwise)."""
    n, h, w = x.shape[:3]
    if h != w:
        raise ValueError(f"dihedral_traced needs square patches, got {h}x{w}")
    si, sj = _dihedral_index(mode, h)
    return x[torch.arange(n, device=x.device).view(n, 1, 1), si, sj]


def _draws(n, h, w, batch, patch, augment, generator, device):
    def randint(hi):
        return torch.randint(0, hi, (batch,), generator=generator,
                             device=device)

    mode = (randint(8) if augment
            else torch.zeros(batch, dtype=torch.int64, device=device))
    return dict(idx=randint(n), oh=randint(h - patch + 1),
                ow=randint(w - patch + 1), mode=mode)


def sample_patches(records: torch.Tensor, batch: int, patch: int,
                   augment: bool = True,
                   extra: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None):
    """A (batch, patch, patch, C) crop batch from (N, H, W, C) records on
    their device: record ``idx``, crop offsets ``oh``/``ow`` and dihedral
    ``mode`` per sample (each (batch,) int64, from ``generator`` unless
    given in ``draws``), assembled by one gather.  ``extra``: a second
    record array cropped and augmented with the same draws (paired noisy /
    gt).  uint8 in, uint8 out: the trainers normalize on the device."""
    n, h, w, _ = records.shape
    if draws is None:
        draws = _draws(n, h, w, batch, patch, augment, generator,
                       records.device)
    si, sj = _dihedral_index(draws["mode"], patch)
    rows = draws["oh"].view(-1, 1, 1) + si
    cols = draws["ow"].view(-1, 1, 1) + sj
    idx = draws["idx"].view(-1, 1, 1)
    out = records[idx, rows, cols]
    return out if extra is None else (out, extra[idx, rows, cols])


def records_from_images(paths, record_size: int, per_image: int = 8,
                        seed: int = 0) -> np.ndarray:
    """One-time host-side crop of fixed-size uint8 records from an image
    folder (the role of the reference's im2patch prep,
    datasets/prepare_data/Denoising/SIDD/im2patch_train.py:67-80): random
    fixed-size crops per source image, the bridge from a folder of
    variable-size images to a device-resident record array.  Images
    smaller than ``record_size`` are reflect-padded up."""
    import cv2

    rng = np.random.default_rng(seed)
    out = []
    for p in sorted(str(x) for x in paths):
        im = cv2.imread(p, cv2.IMREAD_COLOR)
        if im is None:
            raise FileNotFoundError(f"unreadable image: {p}")
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
        h, w = im.shape[:2]
        if h < record_size or w < record_size:
            im = np.pad(im, ((0, max(0, record_size - h)),
                             (0, max(0, record_size - w)), (0, 0)),
                        mode="reflect")
            h, w = im.shape[:2]
        for _ in range(per_image):
            oh = rng.integers(0, h - record_size + 1)
            ow = rng.integers(0, w - record_size + 1)
            out.append(im[oh:oh + record_size, ow:ow + record_size])
    if not out:
        raise ValueError("no images found")
    return np.stack(out).astype(np.uint8)


class DeviceDataset:
    """uint8 record arrays copied to ``device`` once (the card unless the
    caller asks for the CPU) and handed to the training step as tensors."""

    def __init__(self, noisy: np.ndarray, gt: Optional[np.ndarray] = None,
                 device="cuda"):
        if noisy.dtype != np.uint8:
            raise ValueError("device datasets store uint8 records")
        if gt is not None and gt.shape != noisy.shape:
            raise ValueError(f"gt shape {gt.shape} != {noisy.shape}")
        self.device = resolve_device(device)
        self.paired = gt is not None
        self.num_records = int(noisy.shape[0])
        self.rec_shape = tuple(noisy.shape[1:])
        self._upload(noisy, gt)

    def _upload(self, noisy, gt):
        # np.array copies: the records may be read-only views of a file
        self._dev = tuple(
            torch.from_numpy(np.array(a, dtype=np.uint8)).to(self.device)
            for a in ((noisy,) if gt is None else (noisy, gt)))

    @classmethod
    def from_packdb(cls, path, device="cuda"):
        from .packdb import read_packdb_arrays

        noisy, gt = read_packdb_arrays(path)
        return cls(noisy, gt, device=device)

    @property
    def arrays(self) -> Tuple[torch.Tensor, ...]:
        """(noisy,) or (noisy, gt) uint8 tensors on the device."""
        return self._dev

    @property
    def nbytes(self) -> int:
        """Bytes the records hold on the device."""
        return sum(t.numel() * t.element_size() for t in self._dev)

    def refresh(self, noisy: np.ndarray, gt: Optional[np.ndarray] = None):
        """Swap in a new chunk of records of the same shape: the streaming
        path for corpora larger than the device's memory; one copy per
        chunk, between epochs."""
        if (noisy.shape[0] != self.num_records
                or tuple(noisy.shape[1:]) != self.rec_shape):
            raise ValueError("refresh must keep the record array shape")
        if self.paired != (gt is not None):
            raise ValueError("refresh must keep pairedness")
        self._upload(noisy, gt)
