"""Training observability: console + file logging, TensorBoard writer
(counterpart of virnet_tpu/train/logging.py): formatted progress lines,
per-epoch scalars and image grids through tensorboardX, which is optional.
"""

from __future__ import annotations

import logging
import math
import sys
from pathlib import Path

import numpy as np


def make_log(log_path=None, name: str = "virnet_tpu_torch",
             file_level=logging.INFO, stream_level=logging.INFO):
    """File+console logger factory (reference utils/util_common.py:9-39).
    A second call for the same ``name`` replaces the handlers."""
    logger = logging.getLogger(name)
    logger.setLevel(min(file_level, stream_level))
    for handler in list(logger.handlers):
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s", "%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setLevel(stream_level)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_path is not None:
        fh = logging.FileHandler(str(log_path), mode="a")
        fh.setLevel(file_level)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def _to_grid(batch: np.ndarray, normalize: bool = True,
             pad: int = 2) -> np.ndarray:
    """NHWC batch -> single HWC image grid (torchvision make_grid-like)."""
    batch = np.asarray(batch)
    n, h, w, c = batch.shape
    if normalize:
        out = np.empty_like(batch, dtype=np.float32)
        for i in range(n):
            lo, hi = batch[i].min(), batch[i].max()
            out[i] = (batch[i] - lo) / (hi - lo + 1e-8)
        batch = out
    ncol = int(math.ceil(math.sqrt(n)))
    nrow = int(math.ceil(n / ncol))
    grid = np.zeros((nrow * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    dtype=np.float32)
    for i in range(n):
        r, cc = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + cc * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = batch[i]
    return grid


class TrainWriter:
    """Scalar/image writer; no-ops cleanly when tensorboardX is missing."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(str(self.log_dir))
        except ImportError:
            self.writer = None

    @property
    def enabled(self) -> bool:
        """Whether anything is written (tensorboardX is installed)."""
        return self.writer is not None

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def image_grid(self, tag: str, batch, step: int, normalize: bool = True):
        if self.writer is not None:
            grid = _to_grid(np.asarray(batch), normalize)
            self.writer.add_image(tag, grid, step, dataformats="HWC")

    def close(self):
        if self.writer is not None:
            self.writer.close()
