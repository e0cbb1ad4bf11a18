"""Input-pipeline endurance run (counterpart of
virnet_tpu/cli/endurance.py): drive a denoising trainer at full speed for
N minutes and measure whether the host data path keeps the card fed.

The reference feeds its hot loop from torch DataLoader worker processes
(train_denoising_real.py:125-139); the port's equivalent is the native
packdb sampler (data/packdb.py) through the prefetcher (data/prefetch.py),
with the synthesis on the device, or records resident on the device
(``--device_data``, data/device_data.py).  Over a sustained run, what
share of the wall time does the step loop spend waiting on the host
input path?

    python -m virnet_tpu_torch.cli.endurance --minutes 30 --mode real
    python -m virnet_tpu_torch.cli.endurance --minutes 5 --mode syn \
        [--device_data] [--device cpu]

It builds a seeded synthetic pack of 256^2 uint8 records when
``--pack_path`` does not name one, and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def _make_pack(path: Path, n_records: int, size: int, paired: bool):
    """A synthetic SIDD-like pack of seeded uint8 records."""
    from ..data.packdb import write_packdb

    rng = np.random.default_rng(0)
    gt = rng.integers(0, 256, (n_records, size, size, 3), dtype=np.uint8)
    noisy = np.clip(gt.astype(np.int16)
                    + rng.normal(0, 10, gt.shape).astype(np.int16),
                    0, 255).astype(np.uint8)
    write_packdb(path, noisy, gt if paired else None)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--minutes", type=float, default=30.0)
    p.add_argument("--mode", choices=["real", "syn"], default="real")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--patch_size", type=int, default=128)
    p.add_argument("--pack_records", type=int, default=2000)
    p.add_argument("--pack_path", type=str, default="")
    p.add_argument("--num_threads", type=int, default=0,
                   help="packdb sampler threads (0 = auto)")
    p.add_argument("--sync_every", type=int, default=50,
                   help="steps between host reads of the loss")
    p.add_argument("--prefetch", type=int, default=2,
                   help="prefetch depth (0 = sample and copy in the loop)")
    p.add_argument("--device_data", action="store_true",
                   help="copy the pack to the device once and sample every "
                        "batch there: no host bytes per step")
    p.add_argument("--save_dir", type=str, default="./endurance")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..data.packdb import PackDBSampler
    from ..train.loop_denoise import DenoiseTrainConfig, DenoiseTrainer

    pack_path = Path(args.pack_path or
                     Path(args.save_dir) / "endurance_pack.bin")
    pack_path.parent.mkdir(parents=True, exist_ok=True)
    real = args.mode == "real"
    if not pack_path.exists():
        print(f"building a synthetic pack ({args.pack_records} x 256^2)",
              flush=True)
        _make_pack(pack_path, args.pack_records, 256, paired=real)

    arch = (dict(sigma_chn=3, dep_S=8, n_feat=(96, 160, 224, 288),
                 n_resblocks=3) if real
            else dict(sigma_chn=1, dep_S=5, n_feat=(96, 192, 288),
                      n_resblocks=3))
    cfg = DenoiseTrainConfig(batch_size=args.batch_size,
                             patch_size=args.patch_size,
                             save_dir=args.save_dir, **arch)
    trainer = DenoiseTrainer(cfg, real=real, device=args.device)
    dev = trainer.device

    def batches():
        while True:
            yield sampler.sample(args.batch_size, raw=True)

    # the first step (allocator, cuDNN's choices) outside the window
    sampler = dataset = prefetcher = None
    if args.device_data:
        from ..data.device_data import DeviceDataset

        dataset = DeviceDataset.from_packdb(pack_path, device=dev)
        step = lambda _: trainer.run_step_device(dataset, 0)  # noqa: E731
        get_batch = lambda: None  # noqa: E731 (no host work per step)
    else:
        sampler = PackDBSampler(pack_path, args.patch_size,
                                num_threads=args.num_threads)
        if args.prefetch > 0:
            from ..data.prefetch import DevicePrefetcher

            # the input time is then the consumer's wait on the queue
            prefetcher = DevicePrefetcher(batches(), dev, args.prefetch)
            get_batch = prefetcher.__next__
        else:
            get_batch = lambda: sampler.sample(  # noqa: E731
                args.batch_size, raw=True)
        step = lambda b: trainer.run_step(b, 0)  # noqa: E731
    aux = step(get_batch())
    last_loss = float(aux["loss"])

    deadline = time.perf_counter() + args.minutes * 60.0
    input_time = 0.0
    steps = 0
    t_start = time.perf_counter()
    try:
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            batch = get_batch()
            input_time += time.perf_counter() - t0
            aux = step(batch)
            steps += 1
            if steps % args.sync_every == 0:
                last_loss = float(aux["loss"])     # a host read: a sync
                elapsed = time.perf_counter() - t_start
                print(f"step {steps:6d}  {steps / elapsed:6.2f} steps/s  "
                      f"input {100 * input_time / elapsed:5.2f}%  "
                      f"loss {last_loss:.1f}", flush=True)
        last_loss = float(aux["loss"])
        _sync(dev)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if sampler is not None:
            sampler.close()
    total = time.perf_counter() - t_start

    summary = {
        "metric": "endurance",
        "mode": args.mode,
        "device": str(dev),
        "prefetch": 0 if args.device_data else args.prefetch,
        "device_data": bool(args.device_data),
        "minutes": total / 60.0,
        "steps": steps,
        "steps_per_s": steps / total,
        "input_fraction": input_time / total,
        "final_loss_finite": bool(np.isfinite(last_loss)),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
