"""HDF5 benchmark-case reader (counterpart of virnet_tpu/data/h5_bench.py):
the consumer side of data/prepare.write_noise_benchmark_h5 (reference
BaseDataSetH5 + prepare_data/simulation/noise_generate.py: per-case files
with noisy/gt/sigma groups).  h5py is imported when a file is opened, so
the package runs without it."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class H5BenchmarkReader:
    """Iterate (name, noisy, gt, sigma) tuples from a benchmark HDF5."""

    def __init__(self, path):
        import h5py

        self.path = str(path)
        self._h5 = h5py.File(self.path, "r")
        self.names = sorted(self._h5.keys())

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int) -> Tuple[str, np.ndarray, np.ndarray,
                                             np.ndarray]:
        g = self._h5[self.names[idx]]
        return (self.names[idx], g["noisy"][()], g["gt"][()],
                g["sigma"][()])

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self[i]

    def close(self):
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
