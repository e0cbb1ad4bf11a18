"""Serving cells: a closed loop with one client, each request a numpy batch
(``restore_batch``) or image (``restore_image``) handed to the program's
``Restorer`` and its restored numpy array taken back.

The request sequence is fixed by the traffic file: the shapes in turn, and
for each shape the images of a pool made at set-up, in order.  Every shape
is warmed up before the window.  A sample of the requests finished in the
window, drawn from the seed (a reservoir per shape), is kept and judged
against the plain reference once the program is freed.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from . import generate
from .judge import image_gaps, scoped_precision
from .outcome import Outcome


class Reservoir:
    """``k`` of the requests of each shape, uniformly, from ``seed``.  The
    kept answers are copied into arrays made at set-up, so that which
    answers a seed keeps changes nothing of the memory the window
    allocates and frees."""

    def __init__(self, k: int, seed: int, out_shapes: dict):
        self.k, self.rng, self.seen = k, random.Random(seed), {}
        self.slots = {key: np.zeros((k, *shape), np.float32)
                      for key, shape in out_shapes.items()}
        self.which = {key: [None] * k for key in out_shapes}

    def offer(self, key, tag, answer) -> None:
        n = self.seen.get(key, 0)
        self.seen[key] = n + 1
        j = n if n < self.k else self.rng.randrange(n + 1)
        if j < self.k:
            np.copyto(self.slots[key][j], answer)
            self.which[key][j] = tag

    def all(self) -> list:
        """[(shape, pool index, answer)] of every kept request."""
        return [(key, tag, self.slots[key][j])
                for key, tags in self.which.items()
                for j, tag in enumerate(tags) if tag is not None]


def program(cell, device, compute=None):
    """The request function of the program's Restorer as the configuration
    and the traffic state it (``compute`` overrides the traffic's): numpy
    in, numpy out."""
    from virnet_tpu_torch.eval.engine import Restorer

    cfg, entry = cell.config, cell.traffic["entry"]
    r = Restorer(cfg["task"], ckpt_path=cell.root / cfg["weights"],
                 sf=cfg.get("sf", 1),
                 compute=compute or cell.traffic["compute"], device=device)
    if entry == "restore_batch":
        return lambda x: r.restore_batch(x).cpu().numpy()
    if entry == "restore_image":
        return lambda x: r.restore_image(x[0])[None]
    raise ValueError(f"unknown serving entry {entry!r}")


def reference(cell, device, quant=None, tf32=False):
    """The plain reference as a request function (numpy in and out), fp32
    with TF32 off unless ``tf32``."""
    from ..reference.models import load_state, restore

    cfg = cell.config
    params = {k: v.to(device) for k, v in
              load_state(cell.root / cfg["weights"]).items()}

    def call(x):
        with torch.no_grad(), scoped_precision(tf32):
            y = restore(torch.from_numpy(x).to(device), params, cfg["arch"],
                        cfg.get("sf", 1), quant)
        return y.cpu().numpy()
    return call


def run(cell, seed: int, seconds: float, trace: bool, device, t_process,
        make_call=None) -> Outcome:
    """One run of a serving cell.  ``make_call(cell, device)`` builds what
    serves the requests: the program unless given (the calibration's
    controls)."""
    spec = cell.traffic
    call = (make_call or program)(cell, device)
    pools = generate.request_images(spec, seed, device)
    shapes = [tuple(s) for s in spec["shapes"]]

    def request(i):
        shape = shapes[i % len(shapes)]
        j = (i // len(shapes)) % spec["pool"]
        return shape, j, pools[shape][j]

    out_shapes = {}
    for i in range(spec["warmup"] * len(shapes)):
        shape, _, x = request(i)
        out_shapes[shape] = call(x).shape
    keep = Reservoir(spec["sample"], seed, out_shapes)
    sync(device)
    setup_s = time.perf_counter() - t_process

    lat, out_px = [], 0
    t0 = time.perf_counter()
    t_end, i = t0, 0
    while time.perf_counter() - t0 < seconds:
        t_req = time.perf_counter()
        shape, j, x = request(i)
        y = call(x)
        t_end = time.perf_counter()
        lat.append(t_end - t_req)
        out_px += int(np.prod(y.shape[:3]))
        keep.offer(shape, j, y)
        i += 1
    window_s = t_end - t0
    out = Outcome(
        setup_s=setup_s, attempted=i, window_s=window_s,
        end_to_end=dict(
            restore_mp_per_s=out_px / 1e6 / window_s,
            request_ms_p95=float(np.percentile(np.array(lat) * 1e3, 95))),
        compute=spec["compute"],
        extra=latency_readings(lat))
    arch, sf = cell.config["arch"], cell.config.get("sf", 1)
    from .flops import forward_flops

    out.unit_flops = float(np.mean([       # the shapes take turns
        forward_flops(arch, spec["batch"], h, w, sf) for h, w in shapes]))
    if trace:
        from .trace import profile

        out.trace = profile(lambda k: call(request(i + k)[2]),
                            spec["profile"], device)
    out.read_memory(device)
    del call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.kept = keep.all()
    out.pools = pools
    return out


def judge(cell, out: Outcome, device) -> list:
    """The gaps of every kept image from the plain reference's."""
    ref = reference(cell, device)
    return [image_gaps(y, ref(out.pools[shape][j]))
            for shape, j, y in out.kept]


def latency_readings(lat) -> dict:
    """Readings of the window's latencies beside the metrics: percentiles,
    the largest, and how many requests took over 1.15 x the median."""
    ms = np.array(lat) * 1e3
    out = {f"request_ms_p{q}": float(np.percentile(ms, q))
           for q in (50, 90, 99)}
    out.update(request_ms_max=float(ms.max()),
               slow_requests=int((ms > 1.15 * np.median(ms)).sum()))
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
