"""Where the bf16 K3 (csrc/dncnn_head.cu) spends its time, on the card.

    python -m virnet_tpu_torch.cli.bench_k3_phases [--preset syn,real]
        [--iters 5] [--variants all,no_conv1,...]

Builds the kernel once as it is and once per variant with one part
compiled out, then times every variant on the demo weights of the preset
(syn: 32x256^2, L=3, co=1; real: 4x256^2, L=6, co=3) with L2 flushed
before each launch (median of ``iters``).  A variant's time less the
whole kernel's is what that part costs, overlap aside:

  all          the kernel as the package builds it (checked against the
               plain version)
  no_conv1, no_mids, no_last, no_head
               the call of that phase removed (conv1; the L mid levels;
               conv_last with the sigma epilogue; the head conv)
  no_epilogue  the 64-channel epilogue of conv1 and the mids (LeakyReLU,
               rounding, staging, stores) removed, their sums kept alive
  no_stores    only that epilogue's stores to the level buffers removed

The variants compute wrong results on purpose; only 'all' is compared
with the plain version.  A source edit that moves one of the patterns
below makes the tool fail, not time the wrong thing.  Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..convert import load_pth
from ..models.common import hwio
from ..ops import _build
from ..ops import fused_conv as fc
from ..precision import set_parity_mode

ROOT = Path(__file__).resolve().parents[2]
PRESETS = {"syn": ("virnet_denoising_syn_demo.pth", 32),
           "real": ("virnet_denoising_real_demo.pth", 4)}
_PHASE_CALLS = {"no_conv1": "    conv1_level(", "no_mids": "      mid_level(",
                "no_last": "    last_level(", "no_head": "    head_level("}
# (pattern, replacement, how many times the pattern occurs)
_EDITS: Dict[str, List[Tuple[str, str, int]]] = {
    "all": [],
    **{v: [(c, c.replace(c.lstrip(), "if (0) " + c.lstrip()), 1)]
       for v, c in _PHASE_CALLS.items()},
    "no_epilogue": [("    emit64(acc,",
                     "    if (acc[0][0][0] == 1234.5f) emit64(acc,", 2)],
    "no_stores": [("    if (p < mt.npx) {\n      const int",
                   "    if (p < mt.npx && mt.npx < 0) {\n      const int", 1)],
}
_SYMBOLS = ("vt_dncnn_head_grid", "vt_dncnn_head_scratch_elems",
            "vt_dncnn_head")


def variant_source(name: str, src: str) -> str:
    for pattern, repl, count in _EDITS[name]:
        if src.count(pattern) != count:
            raise RuntimeError(f"{name}: {pattern!r} occurs "
                               f"{src.count(pattern)} times in "
                               f"dncnn_head.cu, expected {count}")
        src = src.replace(pattern, repl)
    return src


def build(names: Sequence[str], out_dir: Path) -> Dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    src = (_build.CSRC / "dncnn_head.cu").read_text()
    procs = {}
    for name in names:
        cu = out_dir / f"k3_{name}.cu"
        cu.write_text(variant_source(name, src))
        so = out_dir / f"k3_{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def use(lib: ctypes.CDLL) -> None:
    """Route fused_conv's K3 entries to ``lib``."""
    for sym in _SYMBOLS:
        fn = getattr(lib, sym)
        fn.argtypes = fc._SIGNATURES[sym][1]
        fn.restype = (ctypes.c_longlong if sym.endswith("_scratch_elems")
                      else ctypes.c_int)
        fc._FNS[sym] = fn


def time_cold_ms(fn, iters: int, flush: torch.Tensor) -> float:
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def k3_args(preset: str):
    ckpt, batch = PRESETS[preset]
    sd = load_pth(ROOT / "model_zoo" / ckpt)

    def t(k):
        return sd[k].to("cuda", torch.bfloat16)
    mids = sorted({int(k.split(".")[2]) for k in sd
                   if k.startswith("SNet.mid_layer.")})
    g = torch.Generator().manual_seed(0)
    x = torch.rand(batch, 256, 256, 3, generator=g).to("cuda", torch.bfloat16)
    return (x, hwio(t("SNet.conv1.weight")), t("SNet.conv1.bias"),
            torch.stack([hwio(t(f"SNet.mid_layer.{i}.weight")) for i in mids]),
            torch.stack([t(f"SNet.mid_layer.{i}.bias") for i in mids]),
            hwio(t("SNet.conv_last.weight")), t("SNet.conv_last.bias"),
            hwio(t("RNet.head.weight")), t("RNet.head.bias"))


def run(presets: Sequence[str] = ("syn", "real"),
        variants: Sequence[str] = tuple(_EDITS), iters: int = 5,
        log=print) -> Dict[str, Dict[str, float]]:
    """{preset: {variant: cold ms}}; raises when 'all' disagrees with the
    plain version beyond the bf16 bar (4 ulps of the scale)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_k3_phases needs a CUDA device")
    set_parity_mode()
    kw = dict(lmin=math.log(1e-10), lmax=math.log(1e2))
    res: Dict[str, Dict[str, float]] = {}
    saved = {s: fc._FNS.get(s) for s in _SYMBOLS}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    try:
        _build.build_dir().mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.build_dir()) as d:
            libs = build(variants, Path(d))
            for preset in presets:
                args = k3_args(preset)
                res[preset] = {}
                for name, lib in libs.items():
                    use(lib)
                    if name == "all":
                        head, _ = fc.dncnn_head_fused(*args, **kw)
                        h_ref, _ = fc.dncnn_head_fused_plain(*args, **kw)
                        err = float((head.float() - h_ref.float()).abs().max())
                        tol = 2 ** -6 * max(1.0, float(h_ref.abs().max()))
                        if not err <= tol:
                            raise AssertionError(f"{preset}: head differs "
                                                 f"by {err} (bar {tol})")
                    ms = time_cold_ms(lambda: fc.dncnn_head_fused(*args, **kw),
                                      iters, flush)
                    res[preset][name] = ms
                    log(f"{preset} {name}: {ms:.4f} ms")
    finally:
        for sym, fn in saved.items():
            if fn is None:
                fc._FNS.pop(sym, None)
            else:
                fc._FNS[sym] = fn
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="syn,real")
    ap.add_argument("--variants", default=",".join(_EDITS))
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    run(args.preset.split(","), args.variants.split(","), args.iters)


if __name__ == "__main__":
    main()
