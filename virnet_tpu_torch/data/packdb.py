"""packdb: ctypes bindings of the native packed patch database
(counterpart of virnet_tpu/data/packdb.py; the same ``VPK1`` files).

The writer packs fixed-size uint8 (noisy, gt) records into one file, the
port's replacement for the reference's LMDB pipeline
(datasets/DenoisingDatasets.py:21-99).  The native sampler
(native/packdb.cpp) mmaps the file and produces whole augmented batches
with a C++ thread pool: one ctypes call per batch, no DataLoader workers.

The shared library is built with g++ on first use into the port's build
directory (``ops/_build.build_dir()``: ``build/kernels`` of the checkout,
or ``$VIRNET_TPU_TORCH_BUILD_DIR``), its file name carrying a digest of
the source and the flags; nothing is written beside the source.  A failed
build raises: there is no silent fall-back to the Python samplers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops._build import build_dir

MAGIC = b"VPK1"
SRC = Path(__file__).resolve().parents[2] / "native" / "packdb.cpp"
# no -march=native: a build directory copied along with the checkout must
# run on another machine's CPU
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lib = None


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return build_dir() / f"libpackdb-{h.hexdigest()[:12]}.so"


def _build_library() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def get_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build_library()))
        lib.packdb_open.restype = ctypes.c_void_p
        lib.packdb_open.argtypes = [ctypes.c_char_p]
        lib.packdb_close.argtypes = [ctypes.c_void_p]
        lib.packdb_num_records.restype = ctypes.c_int
        lib.packdb_num_records.argtypes = [ctypes.c_void_p]
        lib.packdb_shape.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_int)] * 4
        lib.packdb_sample.restype = ctypes.c_int
        lib.packdb_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int]
        _lib = lib
    return _lib


def write_packdb(path, noisy: np.ndarray,
                 gt: Optional[np.ndarray] = None) -> None:
    """Write (N, H, W, C) uint8 record arrays into a pack file."""
    noisy = np.ascontiguousarray(noisy, dtype=np.uint8)
    paired = gt is not None
    if paired:
        gt = np.ascontiguousarray(gt, dtype=np.uint8)
        if gt.shape != noisy.shape:
            raise ValueError(f"gt shape {gt.shape} != {noisy.shape}")
    n, h, w, c = noisy.shape
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<5I", n, h, w, c, int(paired)))
        for i in range(n):
            f.write(noisy[i].tobytes())
            if paired:
                f.write(gt[i].tobytes())


def read_packdb_arrays(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A whole pack as (noisy, gt) uint8 arrays (gt None for unpaired
    packs), read-only views of the file mapped into memory; pure Python,
    no library needed."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:4] != MAGIC:
        raise ValueError(f"not a packdb file: {path}")
    n, h, w, c, paired = struct.unpack("<5I", head[4:24])
    body = np.memmap(path, np.uint8, "r", offset=24,
                     shape=(n, 2 if paired else 1, h, w, c))
    return body[:, 0], (body[:, 1] if paired else None)


class PackDBSampler:
    """Batch sampler over a pack file; the call surface of
    data/sources.PairedPatchSampler."""

    def __init__(self, path, patch_size: int, seed: int = 0,
                 num_threads: int = 0):
        self.lib = get_library()
        self.handle = self.lib.packdb_open(str(path).encode())
        if not self.handle:
            raise OSError(f"cannot open packdb: {path}")
        h, w, c, paired = (ctypes.c_int() for _ in range(4))
        self.lib.packdb_shape(self.handle, ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(c), ctypes.byref(paired))
        self.rec_shape = (h.value, w.value, c.value)
        self.paired = bool(paired.value)
        self.patch_size = patch_size
        self.num_threads = num_threads
        self.seed = seed
        self._counter = 0

    def __len__(self):
        return self.lib.packdb_num_records(self.handle)

    def reset_seed(self, seed: int):
        self.seed = seed
        self._counter = 0

    def sample(self, batch_size: int, raw: bool = False):
        """One augmented batch (a pair for paired packs); ``raw=True``
        returns uint8, which the trainers normalize on the device (4x
        fewer bytes to copy)."""
        p = self.patch_size
        out_a = np.empty((batch_size, p, p, self.rec_shape[2]), np.uint8)
        out_b = np.empty_like(out_a) if self.paired else None
        seed = (self.seed << 20) + self._counter
        self._counter += 1
        ptr = ctypes.POINTER(ctypes.c_uint8)
        ret = self.lib.packdb_sample(
            self.handle, batch_size, p, seed, out_a.ctypes.data_as(ptr),
            out_b.ctypes.data_as(ptr) if out_b is not None else None,
            self.num_threads)
        if ret != 0:
            raise RuntimeError(f"packdb_sample failed: {ret}")
        outs = (out_a, out_b) if self.paired else (out_a,)
        if not raw:
            outs = tuple(o.astype(np.float32) / 255.0 for o in outs)
        return outs if self.paired else outs[0]

    def close(self):
        if self.handle:
            self.lib.packdb_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def pack_from_folders(noisy_dir, out_path, keys=("sidd",)) -> int:
    """Pack a SIDD-style paired patch folder tree (<root>/noisy/*.png with
    the GT at <root>/gt/<same name>) into one pack file."""
    from ..ops.color import imread

    noisy_paths = sorted(
        p for p in Path(noisy_dir).glob("*.png")
        if any(k in p.stem for k in keys)) or \
        sorted(Path(noisy_dir).glob("*.png"))
    gt_paths = [Path(p).parents[1] / "gt" / Path(p).name
                for p in noisy_paths]
    noisy = np.stack([imread(p, chn="rgb", dtype="uint8")
                      for p in noisy_paths])
    gt = np.stack([imread(p, chn="rgb", dtype="uint8") for p in gt_paths])
    write_packdb(out_path, noisy, gt)
    return noisy.shape[0]
