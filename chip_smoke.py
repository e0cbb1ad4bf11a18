#!/usr/bin/env python3
"""Smoke run of the virnet_tpu_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--phases build,kernels,serve,profile,serve_odd,
                           ops,real,fp32,psnr] [--report PATH]

Phases (all by default; any failure raises and the exit code is not 0):
  build      nvcc-builds the four CUDA kernels from virnet_tpu_torch/csrc/
  kernels    holds each kernel (K1-K4) against its plain PyTorch version on
             the card at the main paths' shapes, with the weights of both
             presets (syn: L=3, co=1; real: L=6, co=3), in fp32 (TF32 off)
             and bf16, and times kernel, plain version and library call
  serve      Restorer('denoising-syn', bf16) on the flagship 32x256^2 batch
             (K3 + K4), MP/s
  profile    torch.profiler device-time breakdown of that forward by kernel
             group, and the device's idle share
  serve_odd  restore_image at 321x481, a shape that fails the fused-head
             gate (K2 + K4)
  ops        the same image on SNet's per-op route, conv_impl='ops' (K1)
  real       the denoising-real demo weights on a 4x256^2 batch (co=3, L=6)
  fp32       card forward vs the same model on the CPU (plain versions),
             both presets, one shape through K3 and one through K2
  psnr       denoising a seeded smooth image with sigma=25/255 noise

Every main-path phase (serve, serve_odd, ops, real) zeroes the launch
counters, drives its path once and reads them; it fails if a kernel of
its path did not launch.  The line before the card's line is one JSON
object with the kernels' numbers: times and errors from the syn weights
in bf16, and each kernel's launches in the one run of the path it serves
(``launches_path``; every path's count is in ``launches_by_path``).  The
last line is {"ok": true, "device": {...}}.  ``--report PATH`` also
writes a fuller JSON report.  Needs the repo checkout beside this script,
a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ALL_PHASES = ("build", "kernels", "serve", "profile", "serve_odd", "ops",
              "real", "fp32", "psnr")
SYN_CKPT = ROOT / "model_zoo" / "virnet_denoising_syn_demo.pth"
REAL_CKPT = ROOT / "model_zoo" / "virnet_denoising_real_demo.pth"

# card peaks (NVIDIA data sheets, dense): bf16 tensor-core FLOP/s, fp32
# CUDA-core FLOP/s (the kernels run f32 on CUDA cores with TF32 off), and
# memory bytes/s
PEAKS = {
    "H100 SXM": dict(bf16=989e12, fp32=67e12, bytes=3.35e12),
    "H100 PCIe": dict(bf16=756e12, fp32=51e12, bytes=2.0e12),
    "H100 NVL": dict(bf16=835e12, fp32=60e12, bytes=3.9e12),
}

KERNELS = {
    "conv3x3_mid": dict(
        path="ops", source="virnet_tpu_torch/csrc/conv3x3_mid.cu",
        replaces="virnet_tpu/ops/pallas_conv.py:627 (conv3x3_mid_pair), "
                 ":297 (conv3x3_mid_stack_pair)"),
    "dncnn_fused": dict(
        path="serve_odd", source="virnet_tpu_torch/csrc/dncnn_fused.cu",
        replaces="virnet_tpu/ops/pallas_conv.py:474 (dncnn_pair_fused)"),
    "dncnn_head_fused": dict(
        path="serve", source="virnet_tpu_torch/csrc/dncnn_fused.cu",
        replaces="virnet_tpu/ops/pallas_conv.py:1289 (dncnn_head_fused "
                 "halo :1512, carry :1459)"),
    "conv3x3_tail_residual": dict(
        path="serve", source="virnet_tpu_torch/csrc/tail_residual.cu",
        replaces="virnet_tpu/ops/pallas_conv.py:841 "
                 "(conv3x3_tail_residual)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def peaks_for(name: str) -> tuple:
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, dtype, kind="abs"):
    """fp32: atol 1e-4 (rtol 1e-5 for sigma) — the same function in f32
    with only the summation order changed.  bf16: both sides round every
    conv once to bf16 and differ only in the f32 summation order, so a
    1-ulp flip at one level can carry through the later levels; the bound
    is 4 bf16 ulps (2^-6) of the tensor's scale (of log sigma for sigma),
    while a wrong tap moves outputs by a large part of their scale."""
    got = got.float()
    want = want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if kind == "sigma":
        if dtype == torch.float32:
            rel = float(((got - want).abs() / want.abs()).max())
            ok = rel <= 1e-5
            bound = "rtol 1e-5"
            err = rel
        else:
            lw = torch.log(want)
            err = max_err(torch.log(got), lw)
            tol = 2 ** -6 * max(1.0, float(lw.abs().max()))
            ok = err <= tol
            bound = f"log-sigma atol {tol:.3g}"
    else:
        err = max_err(got, want)
        tol = (1e-4 if dtype == torch.float32
               else 2 ** -6 * max(1.0, float(want.abs().max())))
        ok = err <= tol
        bound = f"atol {tol:.3g}"
    log(f"  {name}: max diff {err:.3g} ({bound}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"({err} vs {bound})")
    return err


def snet_params(sd, dtype, dev):
    from virnet_tpu_torch.models.common import hwio

    def t(k):
        return sd[k].to(dev, dtype)
    mids = sorted({int(k.split(".")[2]) for k in sd
                   if k.startswith("SNet.mid_layer.")})
    return dict(
        w1=hwio(t("SNet.conv1.weight")), b1=t("SNet.conv1.bias"),
        wms=torch.stack([hwio(t(f"SNet.mid_layer.{i}.weight"))
                         for i in mids]),
        bms=torch.stack([t(f"SNet.mid_layer.{i}.bias") for i in mids]),
        wl=hwio(t("SNet.conv_last.weight")), bl=t("SNet.conv_last.bias"),
        wh=hwio(t("RNet.head.weight")), bh=t("RNet.head.bias"),
        wt=hwio(t("RNet.tail.weight")), bt=t("RNet.tail.bias"))


def phase_kernels(report, peaks):
    """K1-K4 against their plain versions at the main paths' shapes, for
    both presets: denoising-syn (L=3, co=1) with the flagship batch of 32
    and denoising-real (L=6, co=3) with the `real` phase's batch of 4."""
    from virnet_tpu_torch.convert import load_pth
    from virnet_tpu_torch.models import ARCH_PRESETS

    results: dict = {}
    for label, ckpt, batch in (("syn", SYN_CKPT, 32), ("real", REAL_CKPT, 4)):
        mod = 2 ** (len(ARCH_PRESETS[f"denoising-{label}"]["n_feat"]) - 1)
        check_kernels(load_pth(ckpt), label, batch, mod, peaks, results)
    report["kernels"] = results


def check_kernels(sd, label, batch, mod, peaks, results):
    import torch.nn.functional as F

    from virnet_tpu_torch.ops import fused_conv as fc

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.rand(*shape, generator=g) * scale).to(dev)

    hp, wp = (-(-321 // mod) * mod, -(-481 // mod) * mod)
    x_flag = rand(batch, 256, 256, 3)            # the gated batch
    x_odd = rand(1, 321, 481, 3)                 # fails the gate
    mid_in = rand(1, 321, 481, 64, scale=2.0)    # a mid conv's input there
    feats_flag = rand(batch, 256, 256, 96) - 0.5  # RNet tail input
    feats_pad = rand(1, hp, wp, 96) - 0.5        # padded for 321x481
    for dtype in (torch.float32, torch.bfloat16):
        tag = f"{label} {'fp32' if dtype == torch.float32 else 'bf16'}"
        p = snet_params(sd, dtype, dev)
        esz = torch.finfo(dtype).bits // 8
        peak = peaks["bf16"] if dtype == torch.bfloat16 else peaks["fp32"]
        L, co, cf = p["wms"].shape[0], p["wl"].shape[3], p["wh"].shape[3]
        log(f"[kernels {tag}] L={L} co={co} cf={cf}, batch {batch}x256^2")

        def bound(flops, nbytes):
            t_ops, t_mem = flops / peak * 1e3, nbytes / peaks["bytes"] * 1e3
            return (max(t_ops, t_mem),
                    "operations" if t_ops >= t_mem else "bytes")

        def entry(name, err, k_fn, p_fn, l_fn, flops, nbytes, iters):
            ms = time_ms(k_fn, iters)
            plain_ms = time_ms(p_fn, iters)
            lib_ms = None if l_fn is None else time_ms(l_fn, iters)
            b_ms, b_by = bound(flops, nbytes)
            log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                f" ms, bound {b_ms:.4f} ms ({b_by})")
            results.setdefault(name, {})[tag] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)

        # K1 at the ops route's shape (one mid conv of SNet at 321x481)
        xm = mid_in.to(dtype)
        w, b = p["wms"][0], p["bms"][0]
        got = fc.conv3x3_mid(xm, w, b, 0.25)
        torch.cuda.synchronize()
        err = check_close("conv3x3_mid", got, fc.conv3x3_mid_plain(
            xm, w, b, 0.25), dtype)
        xm_nchw = xm.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        npx = xm.shape[0] * xm.shape[1] * xm.shape[2]
        entry("conv3x3_mid", err, lambda: fc.conv3x3_mid(xm, w, b, 0.25),
              lambda: fc.conv3x3_mid_plain(xm, w, b, 0.25),
              lambda: F.conv2d(xm_nchw, w_oihw, b, padding=1),
              2 * 9 * 64 * 64 * npx, 2 * npx * 64 * esz + w.numel() * esz,
              20)

        snet_flops = 2 * 9 * (3 * 64 + L * 64 * 64 + 64 * co)
        weights_b = sum(p[k].numel() for k in
                        ("w1", "b1", "wms", "bms", "wl", "bl")) * esz
        # K2 at 321x481
        xo = x_odd.to(dtype)
        args2 = (xo, p["w1"], p["b1"], p["wms"], p["bms"], p["wl"], p["bl"])
        got = fc.dncnn_fused(*args2)
        torch.cuda.synchronize()
        err = check_close("dncnn_fused logits", got,
                          fc.dncnn_fused_plain(*args2), dtype)
        npx = 321 * 481
        entry("dncnn_fused", err, lambda: fc.dncnn_fused(*args2),
              lambda: fc.dncnn_fused_plain(*args2), None,
              snet_flops * npx, npx * (3 + co) * esz + weights_b, 5)

        # K3 at the gated batch
        xf = x_flag.to(dtype)
        args3 = args2[1:]
        kw = dict(lmin=math.log(1e-10), lmax=math.log(1e2))
        head, sig = fc.dncnn_head_fused(xf, *args3, p["wh"], p["bh"], **kw)
        torch.cuda.synchronize()
        head_ref, sig_ref = fc.dncnn_head_fused_plain(xf, *args3, p["wh"],
                                                      p["bh"], **kw)
        err = max(check_close("dncnn_head_fused head", head, head_ref, dtype),
                  check_close("dncnn_head_fused sigma", sig, sig_ref, dtype,
                              kind="sigma"))
        npx = batch * 256 * 256
        entry("dncnn_head_fused", err,
              lambda: fc.dncnn_head_fused(xf, *args3, p["wh"], p["bh"], **kw),
              lambda: fc.dncnn_head_fused_plain(xf, *args3, p["wh"], p["bh"],
                                                **kw), None,
              (snet_flops + 2 * 9 * (3 + co) * cf) * npx,
              npx * (3 + co + cf) * esz + weights_b
              + (p["wh"].numel() + cf) * esz, 3)

        # K4: the gated batch (pad-free) and the padded 321x481 case
        wt, bt = p["wt"], p["bt"]
        fp = feats_pad.to(dtype)
        got = fc.conv3x3_tail_residual(fp, x_odd, wt, bt)
        torch.cuda.synchronize()
        check_close("conv3x3_tail_residual (padded)", got,
                    fc.conv3x3_tail_residual_plain(fp, x_odd, wt, bt), dtype)
        ff = feats_flag.to(dtype)
        got = fc.conv3x3_tail_residual(ff, x_flag, wt, bt)
        torch.cuda.synchronize()
        err = check_close("conv3x3_tail_residual", got,
                          fc.conv3x3_tail_residual_plain(ff, x_flag, wt, bt),
                          dtype)
        ff_nchw = ff.permute(0, 3, 1, 2)
        wt_oihw = wt.permute(3, 2, 0, 1).contiguous()
        x_nchw = x_flag.permute(0, 3, 1, 2)
        entry("conv3x3_tail_residual", err,
              lambda: fc.conv3x3_tail_residual(ff, x_flag, wt, bt),
              lambda: fc.conv3x3_tail_residual_plain(ff, x_flag, wt, bt),
              lambda: F.conv2d(ff_nchw, wt_oihw, bt, padding=1) + x_nchw,
              2 * 9 * 96 * 3 * npx, npx * (96 * esz + 3 * 4 + 3 * 4), 10)


GROUPS = (("K3/K2 dncnn_fused.cu", ("dncnn_kernel",)),
          ("K4 tail_residual.cu", ("tail_kernel",)),
          ("K1 conv3x3_mid.cu", ("conv3x3_mid_kernel",)),
          ("library convolutions", ("conv", "cudnn", "xmma", "gemm",
                                    "cutlass", "implicit")))


def phase_profile(restorer, x, report, iters=2):
    """Device time of the flagship forward by kernel group, from
    torch.profiler (CUPTI), and the share of the wall time the device was
    idle (the profiler's own overhead counts as idle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            restorer.restore_batch(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / iters)
    if not kernels:
        log("  device time: not measured (the profiler saw no kernels)")
        report["profile"] = None
        return
    groups: dict = {}
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(kernels.values())
    log(f"  per forward: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {ms:.3f} ms ({ms / busy:.1%} of device time)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:8.3f} ms  {name[:90]}")
    ops = sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                   e.count // iters) for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0), key=lambda r: -r[1])
    for key, ms, count in ops[:6]:
        log(f"    {ms:8.3f} ms  {key} x{count} (torch op, own kernels)")
    report["profile"] = dict(wall_ms=wall_ms, busy_ms=busy, groups=groups,
                             kernels=kernels, torch_ops=ops)


def run_path(name, fn, expect):
    """Drive one main path with the counters zeroed just before and read
    just after; fail if a kernel of the path did not launch."""
    from virnet_tpu_torch.ops import fused_conv as fc

    fc.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(fc.LAUNCHES)
    log(f"  launches {counts}")
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} never launched")
    return out, counts


def check_image(name, out, shape):
    if tuple(out.shape) != tuple(shape):
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != {shape}")
    if not np.isfinite(np.asarray(out)).all():
        raise AssertionError(f"{name}: non-finite output")


def psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * math.log10(1.0 / mse)


def smooth_image(rng, h, w) -> np.ndarray:
    """A seeded smooth clean image: a sum of low-frequency cosines."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    im = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(6):
            fy, fx = rng.uniform(0.5, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            im[..., c] += rng.uniform(0.2, 1.0) * np.cos(
                2 * np.pi * (fy * yy + fx * xx) + ph)
    im = (im - im.min()) / (im.max() - im.min())
    return (0.1 + 0.8 * im).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the full results as JSON here")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    bad = [p for p in phases if p not in ALL_PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "virnet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the virnet_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from virnet_tpu_torch.eval.engine import Restorer
    from virnet_tpu_torch.ops import _build
    from virnet_tpu_torch.precision import set_parity_mode

    report = {}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    table, peaks = peaks_for(kind)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"peaks from the {table} data sheet: {peaks}")
    report.update(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, peaks=dict(table=table, **peaks))
    set_parity_mode()
    t_all = time.perf_counter()

    if "build" in phases:
        t0 = time.perf_counter()
        secs = _build.build_all()
        report["build_s"] = time.perf_counter() - t0
        log(f"[build] {report['build_s']:.1f} s {secs}")
        for lib in sorted(_build.build_dir().glob("*.log")):
            for line in lib.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {lib.stem}: {line.strip()}")

    if "kernels" in phases:
        phase_kernels(report, peaks)

    launches: dict = {}       # path -> the counts of its one run
    rng = np.random.default_rng(0)
    odd = rng.random((321, 481, 3), dtype=np.float32)
    if any(p in phases for p in ("serve", "profile", "serve_odd", "ops",
                                 "psnr")):
        syn = Restorer("denoising-syn", ckpt_path=SYN_CKPT, compute="bf16")

    if "serve" in phases:
        log("[serve] denoising-syn bf16, restore_batch 32x256x256")
        x = torch.as_tensor(rng.random((32, 256, 256, 3), dtype=np.float32),
                            device="cuda")
        out, launches["serve"] = run_path(
            "serve", lambda: syn.restore_batch(x),
            ("dncnn_head_fused", "conv3x3_tail_residual"))
        check_image("serve", out.cpu(), (32, 256, 256, 3))
        t0 = time.perf_counter()
        for _ in range(3):
            syn.restore_batch(x)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 3
        report["serve"] = dict(s_per_batch=sec,
                               mp_per_s=32 * 256 * 256 / sec / 1e6)
        log(f"  {sec * 1e3:.2f} ms per batch, "
            f"{report['serve']['mp_per_s']:.2f} MP/s")

    if "profile" in phases:
        log("[profile] flagship forward, device time by kernel")
        x = torch.as_tensor(rng.random((32, 256, 256, 3), dtype=np.float32),
                            device="cuda")
        syn.restore_batch(x)                     # warm-up
        phase_profile(syn, x, report)

    if "serve_odd" in phases:
        log("[serve_odd] restore_image 321x481 (K2 + K4)")
        out_odd, launches["serve_odd"] = run_path(
            "serve_odd", lambda: syn.restore_image(odd),
            ("dncnn_fused", "conv3x3_tail_residual"))
        check_image("serve_odd", out_odd, (321, 481, 3))

    if "ops" in phases:
        log("[ops] restore_image 321x481 on the per-op SNet route (K1)")
        syn_ops = Restorer("denoising-syn", ckpt_path=SYN_CKPT,
                           compute="bf16", conv_impl="ops")
        out_ops, launches["ops"] = run_path(
            "ops", lambda: syn_ops.restore_image(odd),
            ("conv3x3_mid", "conv3x3_tail_residual"))
        check_image("ops", out_ops, (321, 481, 3))
        d = float(np.abs(out_ops - syn.restore_image(odd)).max())
        log(f"  max diff vs the fused route {d:.3g} (bound 4/255)")
        if d > 4 / 255:
            raise AssertionError("ops route disagrees with fused route")
        del syn_ops

    if "real" in phases:
        log("[real] denoising-real bf16, restore_batch 4x256x256")
        real = Restorer("denoising-real", ckpt_path=REAL_CKPT,
                        compute="bf16")
        x = torch.as_tensor(rng.random((4, 256, 256, 3), dtype=np.float32),
                            device="cuda")
        out, launches["real"] = run_path(
            "real", lambda: real.restore_batch(x),
            ("dncnn_head_fused", "conv3x3_tail_residual"))
        check_image("real", out.cpu(), (4, 256, 256, 3))
        del real

    if "fp32" in phases:
        from virnet_tpu_torch.convert import load_pth
        from virnet_tpu_torch.models import build_model

        report["fp32"] = {}
        for task, ckpt in (("denoising-syn", SYN_CKPT),
                           ("denoising-real", REAL_CKPT)):
            log(f"[fp32] {task}: card forward vs CPU plain versions")
            sd = load_pth(ckpt)
            cpu = build_model(task)
            cpu.load_state_dict(sd, strict=True)
            gpu = build_model(task)
            gpu.load_state_dict(sd, strict=True)
            gpu = gpu.cuda().eval()
            cpu.eval()
            # (64, 64) passes the fused-head gate (K3), (29, 35) fails it (K2)
            for hw in ((64, 64), (29, 35)):
                x = rng.random((1, *hw, 3), dtype=np.float32)
                with torch.inference_mode():
                    mu_c, s_c = cpu(torch.from_numpy(x))
                    mu_g, s_g = gpu(torch.from_numpy(x).cuda())
                e_mu = max_err(mu_g.cpu(), mu_c)
                e_s = float(((s_g.cpu() - s_c).abs() / s_c.abs()).max())
                log(f"  {hw}: mu max diff {e_mu:.3g} (atol 1e-4), sigma max "
                    f"rel diff {e_s:.3g} (rtol 1e-5)")
                if e_mu > 1e-4 or e_s > 1e-5:
                    raise AssertionError(
                        f"fp32 card forward of {task} disagrees at {hw}: "
                        f"mu {e_mu}, sigma rel {e_s}")
                report["fp32"][f"{task} {hw}"] = dict(mu_abs=e_mu,
                                                      sigma_rel=e_s)

    if "psnr" in phases:
        log("[psnr] sigma=25/255 noise on a smooth image, syn demo bf16")
        clean = smooth_image(np.random.default_rng(1), 256, 256)
        noisy = (clean + np.random.default_rng(2).normal(
            0, 25 / 255, clean.shape)).astype(np.float32)
        restored = syn.restore_image(noisy)
        p_in, p_out = psnr(np.clip(noisy, 0, 1), clean), psnr(restored, clean)
        log(f"  PSNR noisy {p_in:.2f} dB -> restored {p_out:.2f} dB")
        report["psnr"] = dict(noisy=p_in, restored=p_out)
        if not p_out > p_in:
            raise AssertionError("restoration did not raise the PSNR")

    report["launches"] = launches
    report["total_s"] = time.perf_counter() - t_all
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))

    # one row per kernel: its times and error at the flagship checkpoint
    # in bf16, and its launches in the one run of the path it serves
    rows = []
    for name, meta in KERNELS.items():
        m = report.get("kernels", {}).get(name, {}).get("syn bf16", {})
        rows.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=launches.get(meta["path"], {}).get(name, 0),
            launches_path=meta["path"],
            launches_by_path={p: c[name] for p, c in launches.items()},
            max_abs_err=m.get("max_abs_err"), ms=m.get("ms"),
            plain_ms=m.get("plain_ms"), bound_ms=m.get("bound_ms"),
            bound_by=m.get("bound_by"), library_ms=m.get("library_ms")))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
