"""A/B of the fused denoise prologue on the card (counterpart of
tools/bench_fused_head.py in the JAX package).

    python -m virnet_tpu_torch.cli.bench_fused_head \
        [--variants unfused,halo,slabzero:r32] [--batch 32] [--size 256] \
        [--reps 3] [--chain 4] [--device cpu]

Times one apply of the denoising-syn preset (random weights from a seed,
bf16) at the flagship serving shape, per variant:

  unfused         the ``conv_impl='torch'`` model: SNet, RNet's head and
                  tail through cuDNN, no kernel of this package;
  halo, carry     the fused prologue K3, RNet, the tail K4 (on Hopper the
                  two modes are one kernel);
  slabzero[:rN]   the halo-free probe K8 on N-row slabs (default 32) in
                  K3's place.  Its output is wrong near slab edges
                  (ops/fused_conv.dncnn_head_slabzero): only its time
                  means anything.  K8 runs K3's own level chain on the
                  slabs, which recomputes nothing either way, so halo -
                  slabzero:r32 should be about 0.

A fused variant takes an optional row-slab size (``halo:r16`` is accepted
and means ``halo``: K3 has no row slabs).  ``+tail`` is accepted as in the
JAX tool: the fused variants run the tail kernel K4 anyway, and
``unfused+tail`` swaps cuDNN's tail for K4.

Every variant is built up front, then the variants take turns within each
repetition, so that drift of the card's clocks spreads over all of them.
One timing is ``chain`` applies in a row, each fed the clamped output of
the one before, between two CUDA events (a host clock on the CPU).  A
variant that does not build or launch is an error.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models import build_model
from ..models.fused import denoise_forward_fused, fused_head_supported
from ..ops import fused_conv as fc
from ..precision import compute_dtype, resolve_device, set_parity_mode

FUSED_MODES = ("halo", "carry", "slabzero")
DEFAULT_VARIANTS = ("unfused", "halo", "slabzero:r32")


def parse_variant(spec: str) -> Tuple[str, str, Optional[int], bool]:
    """'slabzero:r16+tail' -> (name, mode, rows, tail)."""
    spec = spec.strip()
    tail = spec.endswith("+tail")
    if tail:
        spec = spec[:-len("+tail")]
    mode, _, rstr = spec.partition(":")
    if mode != "unfused" and mode not in FUSED_MODES:
        raise ValueError(f"unknown variant {spec!r}: unfused or one of "
                         f"{FUSED_MODES}, with an optional ':rN' and '+tail'")
    rows = int(rstr.lstrip("r")) if rstr else None
    if mode == "unfused" and rows is not None:
        raise ValueError("the unfused variant takes no row-slab size")
    name = mode if rows is None else f"{mode}:r{rows}"
    return name + ("+tail" if tail else ""), mode, rows, tail


def _applies(variants, task, dtype, device, seed, shape, overrides):
    """{name: apply(x) -> mu} for the parsed variants, all with one set of
    weights; raises when ``shape`` does not take the fused prologue."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        first = build_model(task, conv_impl="torch", **overrides)
    state = first.state_dict()
    models = {}

    def model_for(kind):
        # 'unfused': cuDNN throughout; 'tail': cuDNN with the tail kernel;
        # 'fused': the kernels' route
        if kind not in models:
            m = build_model(task, conv_impl="fused" if kind == "fused"
                            else "torch", **overrides)
            m.load_state_dict(state, strict=True)
            if kind == "tail":
                m.RNet.tail_impl = "fused"
            models[kind] = m.to(device, dtype).eval()
        return models[kind]

    out = {}
    for name, mode, rows, tail in variants:
        if mode == "unfused":
            model = model_for("tail" if tail else "unfused")
            out[name] = lambda x, m=model: m(x)[0]
            continue
        model = model_for("fused")
        if not fused_head_supported(model, shape):
            raise ValueError(f"{tuple(shape)} does not take the fused "
                             f"prologue (models/fused.fused_head_supported)")
        out[name] = (lambda x, m=model, mo=mode, r=rows:
                     denoise_forward_fused(m, x, mode=mo, rows=r)[0])
    return out


def run(variants: Sequence[str] = DEFAULT_VARIANTS, batch: int = 32,
        size: int = 256, reps: int = 3, chain: int = 4, device="cuda",
        task: str = "denoising-syn", compute: str = "bf16", seed: int = 0,
        log=None, **model_overrides) -> Dict[str, dict]:
    """Time each variant; returns {name: dict(ms=[per rep], best_ms,
    mp_per_s, launches)}.  ``launches`` are the kernel launches of one
    apply, the counters zeroed just before it.  ``model_overrides`` go to
    ``build_model`` (a narrow model for a CPU test)."""
    dev = resolve_device(device)
    dtype = compute_dtype(compute)
    if dev.type == "cuda":
        set_parity_mode()
    parsed = [parse_variant(v) for v in variants]
    if len({p[0] for p in parsed}) != len(parsed):
        raise ValueError(f"variants repeat: {[p[0] for p in parsed]}")
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(batch, size, size, 3, generator=gen).to(dev)
    applies = _applies(parsed, task, dtype, dev, seed, x.shape,
                       model_overrides)
    say = log or (lambda msg: None)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    res = {}
    with torch.inference_mode():
        for name, apply in applies.items():        # build, warm up, count
            apply(x)
            sync()
            fc.reset_launches()
            mu = apply(x)
            sync()
            if tuple(mu.shape) != tuple(x.shape) or not bool(
                    torch.isfinite(mu).all()):
                raise RuntimeError(f"{name}: output is not a finite image of "
                                   f"the input's shape")
            res[name] = dict(ms=[], launches={k: v for k, v in
                                              fc.LAUNCHES.items() if v})
            say(f"{name}: built, launches of one apply "
                f"{res[name]['launches']}")

        def timed(apply):
            y = x
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(chain):
                    y = torch.clamp(apply(y).float(), 0.0, 1.0)
                end.record()
                sync()
                return start.elapsed_time(end) / chain
            t0 = time.perf_counter()
            for _ in range(chain):
                y = torch.clamp(apply(y).float(), 0.0, 1.0)
            return (time.perf_counter() - t0) * 1e3 / chain

        mp = batch * size * size / 1e6
        for rep in range(reps):
            for name, apply in applies.items():
                ms = timed(apply)
                res[name]["ms"].append(ms)
                say(f"rep{rep} {name}: {ms:.2f} ms/apply = "
                    f"{mp / ms * 1e3:.2f} MP/s")
    for r in res.values():
        r["best_ms"] = min(r["ms"])
        r["mp_per_s"] = mp / r["best_ms"] * 1e3
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(DEFAULT_VARIANTS),
                    help="comma list of unfused, halo, carry, slabzero; "
                         "fused variants take ':rN', any takes '+tail'")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--chain", type=int, default=4,
                    help="applies in a row per timing")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    def log(msg):
        print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)

    res = run(args.variants.split(","), batch=args.batch, size=args.size,
              reps=args.reps, chain=args.chain, device=args.device, log=log)
    print()
    for name, r in res.items():
        print(f"{name}: ms/apply {['%.2f' % m for m in r['ms']]}  best "
              f"{r['best_ms']:.2f} -> {r['mp_per_s']:.2f} MP/s")


if __name__ == "__main__":
    main()
