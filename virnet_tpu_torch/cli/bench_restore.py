"""Serving latency on the card: ``Restorer.restore_image`` on a seeded
image of one size (the copies to and from the card included), or with
``--batch N`` ``Restorer.restore_batch`` on a seeded batch on the card.

    python -m virnet_tpu_torch.cli.bench_restore [--task denoising-syn] \
        [--size 321x481] [--batch 0] [--compute bf16] [--reps 30] \
        [--ckpt PATH]

The default size is a CBSD68 image's (321x481), which fails the fused-head
gate (models/fused.py:fused_head_supported), so SNet runs K2, RNet its pad
and head in torch, and the tail K4; 32 x 256x256 passes it (K3).  Each
call is timed by the host clock and ends in a synchronisation with the
card; three calls warm up first.  Prints one JSON line: the median and
least ms per call, and the card.  Needs a CUDA device.
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
         "denoising-real": ZOO / "virnet_denoising_real_demo.pth"}


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


def main(argv=None) -> int:
    from virnet_tpu_torch.eval.engine import Restorer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="denoising-syn", choices=sorted(CKPTS))
    ap.add_argument("--size", default="321x481", help="HxW")
    ap.add_argument("--batch", type=int, default=0,
                    help="time restore_batch on N images (0: restore_image)")
    ap.add_argument("--compute", default="bf16", choices=("bf16", "fp32"))
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--ckpt", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device: this measures the card")
    h, w = (int(v) for v in args.size.split("x"))
    restorer = Restorer(args.task, ckpt_path=args.ckpt or CKPTS[args.task],
                        compute=args.compute)
    rng = np.random.default_rng(0)
    if args.batch:
        x = torch.as_tensor(rng.random((args.batch, h, w, 3),
                                       dtype=np.float32), device="cuda")
        res = time_calls(lambda: restorer.restore_batch(x), args.reps)
    else:
        image = rng.random((h, w, 3), dtype=np.float32)
        res = time_image(restorer, image, args.reps)
    print(json.dumps(dict(task=args.task, size=[h, w], batch=args.batch,
                          compute=args.compute,
                          card=torch.cuda.get_device_name(0),
                          median_ms=res["median_ms"], min_ms=res["min_ms"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
