"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and becomes one shared
library, compiled for ``sm_90a`` at first use into the build directory
(``$VIRNET_TPU_TORCH_BUILD_DIR``, default ``build/kernels`` at the root of
the checkout, which .gitignore lists).  A library's file name carries a
digest of its sources and flags, so an edited source is rebuilt.  No
PyTorch headers are involved: a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("conv3x3_mid", "dncnn_head", "snet_levels", "tail_residual",
           "blur", "conv_w8a8", "resblock_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}


def build_dir() -> Path:
    env = os.environ.get("VIRNET_TPU_TORCH_BUILD_DIR")
    return (Path(env) if env
            else Path(__file__).resolve().parents[2] / "build" / "kernels")


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns {name: seconds}
    (0.0 for a library found built); raises with nvcc's output on a
    failed build.  ptxas's register/shared-memory report lands beside
    each library as ``<lib>.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    secs = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
