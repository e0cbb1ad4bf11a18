"""LMDB -> packdb converter (counterpart of virnet_tpu/data/lmdb_convert.py):
ingest the reference's prepared LMDB patch databases into the pack format
of data/packdb.py.

The reference trains real-noise models from an LMDB of fixed-size uint8
patch pairs keyed ``<dataset>_..._noisy...`` / ``<dataset>_..._gt...``
with raw-buffer values (datasets/DenoisingDatasets.py:21-99,
utils/util_image.py:183-193 read_img_lmdb).  A user holding such a
database converts it once::

    python -m virnet_tpu_torch.data.lmdb_convert --lmdb_dir sidd.lmdb \
        --out sidd.pack --datasets sidd

and feeds the result to ``PackDBSampler`` or ``DeviceDataset.from_packdb``
through the config's ``train_pack_file``.  ``lmdb`` is an optional
dependency: it is imported when a conversion starts, and its absence
raises an ImportError that says so.  The patch shape is taken from
``--shape H W C`` or inferred from the buffer length (square RGB or gray,
the reference's only layouts).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from .packdb import MAGIC


class PackDBWriter:
    """Streaming writer of the pack format (the layout of
    packdb.write_packdb, one record at a time, so a multi-GB LMDB never
    has to fit in memory).  The record count goes into the header on
    ``close``."""

    def __init__(self, path, shape: Tuple[int, int, int], paired: bool):
        self.path = Path(path)
        self.shape = tuple(shape)
        self.paired = paired
        self.n = 0
        h, w, c = self.shape
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<5I", 0, h, w, c, int(paired)))

    def append(self, noisy: np.ndarray, gt: Optional[np.ndarray] = None):
        noisy = np.ascontiguousarray(noisy, dtype=np.uint8)
        if noisy.shape != self.shape:
            raise ValueError(f"record shape {noisy.shape} != {self.shape}")
        if self.paired != (gt is not None):
            raise ValueError("paired flag does not match record")
        self._f.write(noisy.tobytes())
        if gt is not None:
            gt = np.ascontiguousarray(gt, dtype=np.uint8)
            if gt.shape != self.shape:
                raise ValueError(f"gt shape {gt.shape} != {self.shape}")
            self._f.write(gt.tobytes())
        self.n += 1

    def close(self):
        self._f.seek(len(MAGIC))
        self._f.write(struct.pack("<I", self.n))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _infer_shape(nbytes: int) -> Tuple[int, int, int]:
    """Square RGB first (the reference's patch layout), then square gray."""
    for c in (3, 1):
        if nbytes % c == 0:
            side = int(round((nbytes // c) ** 0.5))
            if side * side * c == nbytes:
                return (side, side, c)
    raise ValueError(
        f"cannot infer a square HxWxC uint8 shape from {nbytes} bytes; "
        "pass shape=(H, W, C) explicitly")


def iter_lmdb_pairs(lmdb_dir, datasets: Sequence[str] = ("sidd",),
                    shape: Optional[Tuple[int, int, int]] = None
                    ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
    """Yield (noisy, gt) uint8 patch pairs from a reference-format LMDB.
    Keys pair as DataLMDB._get_keys does (DenoisingDatasets.py:46-62):
    the keys holding a dataset tag and 'noisy', sorted; the gt key is the
    same with 'noisy' -> 'gt'."""
    try:
        import lmdb
    except ImportError as exc:         # optional dependency
        raise ImportError(
            "the LMDB converter needs the 'lmdb' package (only required "
            "for ingesting reference-prepared databases)") from exc

    env = lmdb.open(str(lmdb_dir), readonly=True, lock=False,
                    readahead=False, meminit=False)
    try:
        with env.begin(write=False) as txn:
            with txn.cursor() as curs:
                keys = [k.decode() for k, _ in curs]
        tags = tuple(d.lower() for d in datasets)
        keys_noisy = sorted(
            k for k in keys
            if "noisy" in k and any(t in k.lower() for t in tags))
        if not keys_noisy:
            raise ValueError(
                f"no 'noisy' keys matching datasets {tags} in {lmdb_dir}")
        with env.begin(write=False) as txn:
            for kn in keys_noisy:
                buf_n = txn.get(kn.encode())
                buf_g = txn.get(kn.replace("noisy", "gt").encode())
                if buf_g is None:
                    raise KeyError(f"missing gt record for {kn!r}")
                shp = shape or _infer_shape(len(buf_n))
                yield (np.frombuffer(buf_n, np.uint8).reshape(shp),
                       np.frombuffer(buf_g, np.uint8).reshape(shp))
    finally:
        env.close()


def lmdb_to_packdb(lmdb_dir, out_path,
                   datasets: Sequence[str] = ("sidd",),
                   shape: Optional[Tuple[int, int, int]] = None) -> int:
    """Convert; returns the number of records written."""
    writer = None
    try:
        for noisy, gt in iter_lmdb_pairs(lmdb_dir, datasets, shape):
            if writer is None:
                writer = PackDBWriter(out_path, noisy.shape, paired=True)
            writer.append(noisy, gt)
    finally:
        if writer is not None:
            writer.close()
    if writer is None:
        raise ValueError(f"no records converted from {lmdb_dir}")
    return writer.n


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lmdb_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--datasets", nargs="+",
                   default=["sidd", "renoir", "polyu"],
                   help="key tags to include (DataLMDB's sidd/renoir/"
                        "polyu flags)")
    p.add_argument("--shape", nargs=3, type=int, default=None,
                   metavar=("H", "W", "C"))
    args = p.parse_args(argv)
    n = lmdb_to_packdb(args.lmdb_dir, args.out, args.datasets,
                       tuple(args.shape) if args.shape else None)
    print(f"wrote {n} records -> {args.out}")


if __name__ == "__main__":
    main()
