"""Serving latency on the card: ``Restorer.restore_image`` on a seeded
image of one size (the copies to and from the card included), or with
``--batch N`` ``Restorer.restore_batch`` on a seeded batch on the card.

    python -m virnet_tpu_torch.cli.bench_restore [--task denoising-syn] \
        [--sf 4] [--size 321x481] [--batch 0] [--compute bf16] [--reps 30] \
        [--ckpt PATH] [--profile] [--cudnn]

The default size is a CBSD68 image's (321x481), which fails the fused-head
gate (models/fused.py:fused_head_supported), so SNet runs K2, RNet its pad
and head in torch, and the tail K4; 32 x 256x256 passes it (K3).  ``--task
sisr`` serves the LR image of that size at ``--sf`` (default weights
``model_zoo/virnet_sisr_x{sf}_demo.pth``; K2 and K4).  Each call is timed
by the host clock and ends in a synchronisation with the card; three calls
warm up first.  Prints one JSON line: the median and least ms per call,
the output megapixels per second at the median, and the card;
``--profile`` adds the device kernels of one more call, longest first
(torch.profiler).  ``--cudnn`` serves fp32 with the library convolutions
on cuDNN (its heuristics choosing) instead of the im2col route that
``Restorer`` takes in fp32 (``precision.im2col_convs``), to compare the
two at a shape.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

ZOO = Path(__file__).resolve().parents[2] / "model_zoo"
CKPTS = {"denoising-syn": ZOO / "virnet_denoising_syn_demo.pth",
         "denoising-real": ZOO / "virnet_denoising_real_demo.pth",
         "sisr": ZOO / "virnet_sisr_x{sf}_demo.pth"}


def default_ckpt(task: str, sf: int) -> Path:
    return Path(str(CKPTS[task]).format(sf=sf))


def time_calls(fn, reps: int = 30, warmup: int = 3) -> dict:
    """ms per ``fn()`` by the host clock, each call ending in a
    synchronisation with the card when there is one: median, least, all."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    for _ in range(warmup):
        fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(median_ms=float(np.median(ms)), min_ms=min(ms), ms=ms)


def time_image(restorer, image: np.ndarray, reps: int = 30,
               warmup: int = 3) -> dict:
    """ms per ``restorer.restore_image(image)``."""
    return time_calls(lambda: restorer.restore_image(image), reps, warmup)


def profile_calls(fn, iters: int = 1) -> dict:
    """torch.profiler (CUPTI) of ``iters`` calls of ``fn()``, each per
    call: ``wall_ms``; ``kernels``, {device kernel: [ms, launches]}; and
    ``torch_ops``, [aten op, ms of its own kernels, count], longest
    first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    kernels = {k: [us / 1e3 / iters, n // iters]
               for k, (us, n) in kernels.items()}
    ops = sorted(([e.key, e.self_device_time_total / 1e3 / iters,
                   e.count // iters] for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0), key=lambda r: -r[1])
    return dict(wall_ms=wall_ms, kernels=kernels, torch_ops=ops)


def device_kernels(fn, top: int = 12) -> list:
    """The device kernels of one ``fn()`` call (``profile_calls``): [name
    (its first 120 characters), ms, launches], longest first, at most
    ``top`` rows."""
    kernels = profile_calls(fn)["kernels"]
    return [[name[:120], ms, n] for name, (ms, n) in
            sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="denoising-syn", choices=sorted(CKPTS))
    ap.add_argument("--sf", type=int, default=4, choices=(2, 3, 4),
                    help="SISR scale factor (--task sisr)")
    ap.add_argument("--size", default="321x481", help="HxW (the LR size "
                    "for sisr)")
    ap.add_argument("--batch", type=int, default=0,
                    help="time restore_batch on N images (0: restore_image)")
    ap.add_argument("--compute", default="bf16", choices=("bf16", "fp32"))
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--ckpt", type=Path, default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also list the device kernels of one call")
    ap.add_argument("--cudnn", action="store_true",
                    help="fp32: library convolutions on cuDNN instead of "
                    "the im2col route")
    return ap


def main(argv=None) -> int:
    from virnet_tpu_torch.eval.engine import Restorer

    ap = build_parser()
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device: this measures the card")
    h, w = (int(v) for v in args.size.split("x"))
    restorer = Restorer(args.task, sf=args.sf, compute=args.compute,
                        ckpt_path=args.ckpt or default_ckpt(args.task,
                                                            args.sf))
    if args.cudnn:
        restorer.im2col = False
    rng = np.random.default_rng(0)
    if args.batch:
        x = torch.as_tensor(rng.random((args.batch, h, w, 3),
                                       dtype=np.float32), device="cuda")
        call = lambda: restorer.restore_batch(x)          # noqa: E731
        res = time_calls(call, args.reps)
    else:
        image = rng.random((h, w, 3), dtype=np.float32)
        call = lambda: restorer.restore_image(image)      # noqa: E731
        res = time_image(restorer, image, args.reps)
    out_px = max(args.batch, 1) * h * w * restorer.sf ** 2
    line = dict(task=args.task, sf=restorer.sf, size=[h, w],
                batch=args.batch, compute=args.compute,
                im2col=restorer.im2col,
                card=torch.cuda.get_device_name(0),
                median_ms=res["median_ms"], min_ms=res["min_ms"],
                out_mp_per_s=out_px / res["median_ms"] / 1e3)
    if args.profile:
        line["kernels"] = device_kernels(call)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
