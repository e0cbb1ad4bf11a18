#!/usr/bin/env python3
"""Run one cell of the benchmark of virnet_tpu_torch once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic (BENCHMARK.json names them),
warms up every shape the cell uses, measures for ``--seconds``, judges
what the timed path produced against the plain reference, and prints one
JSON line as the last line of its standard output.  Without a card (or
with fewer cards than the cell asks for) it exits with 3 and prints no
result.  See portbench/README.md.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def fixed_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds and compiles."""
    cache = root / "build"
    os.environ["VIRNET_TPU_TORCH_BUILD_DIR"] = str(cache / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "2")


if __name__ == "__main__":
    fixed_caches(ROOT)
    sys.path.insert(0, str(ROOT))
    from portbench.core.main import main

    sys.exit(main(sys.argv[1:], root=ROOT, t_process=T_PROCESS))
