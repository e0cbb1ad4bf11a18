#!/usr/bin/env python3
"""Smoke run of the virnet_tpu_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--phases build,kernels,serve,profile,serve_odd,
                           ops,real,fp32,psnr,probe,sisr_fwd,train_fp32,
                           train_sisr,train_denoise_fp32,train_denoise]
                          [--report PATH]

Phases (all by default; any failure raises and the exit code is not 0):
  build      nvcc-builds the CUDA kernels from virnet_tpu_torch/csrc/
  kernels    holds each kernel (K1-K4, K8) against its plain PyTorch version
             on the card at the main paths' shapes, with the weights of both
             presets (syn: L=3, co=1; real: L=6, co=3), in fp32 (TF32 off)
             and bf16, and times kernel, plain version and library call; K2
             also at 8x321x481 (the batch of Restorer.restore_images), K2
             and fp32 K3 (the level chain of csrc/snet_levels.cu) with each
             level timed alone, the level chain in bf16 with the head mode
             at the flagship batch beside K3 bf16 (a measurement, routed
             nowhere), and at the real weights the logits error of K2 and
             the spread of the plain version, card against CPU; the
             probe K8 (K3's device code on the slab view: dncnn_head.cu in
             bf16, the level chain in fp32) on 8-, 16- and 32-row slabs,
             its rows far from slab edges also against K3's output one row
             up (the largest difference printed), timed at 8, 16, 32 and
             beside its library route on the shifted slab view;
             then the blur kernels (K5 forward, K6 dX, K7 dW) in f32 at the
             training shape (16x192^2x3, k=21; also through the public op
             in both pad modes with autograd), one eval shape (1x512^2x3)
             and one awkward shape (2x13x17x2, k=5), K6 and K7 run twice
             for equal bits; K5 and K6 at the training shape also through
             a second build of blur.cu whose images take the any-C build
             (same bits required; its time is any_c_ms)
  serve      Restorer('denoising-syn', bf16) on the flagship 32x256^2 batch
             (K3 + K4), MP/s
  profile    torch.profiler device-time breakdown of that forward by kernel
             group, and the device's idle share
  serve_odd  restore_image at 321x481, a shape that fails the fused-head
             gate (K2: snet_conv1, K1 x3, snet_last; then K4), ms per image
  ops        the same image on SNet's per-op route, conv_impl='ops' (K1),
             ms per image
  real       the denoising-real demo weights on a 4x256^2 batch (co=3, L=6)
  fp32       card forward vs the same model on the CPU (plain versions),
             both presets, one shape through K3 and one through K2 (the
             level chain in fp32); launches of the syn forwards
  psnr       denoising a seeded smooth image with sigma=25/255 noise
  probe      cli.bench_fused_head.run at the flagship shape, full width:
             unfused, halo (K3 + K4) and slabzero (K8 + K4) on 8-, 16- and
             32-row slabs; launches of one apply of each, ms per apply, MP/s
             and halo - slabzero (K8 runs K3's kernel on slabs, so at 32
             rows this is what K3's row halo costs an apply)
  sisr_fwd   VIRNetSR with the x4 demo weights on a 4x48x48 LR batch, card
             (K2 + K4) vs CPU in fp32
  train_fp32 one SISR training step at 2x96^2 (full width) in fp32 with
             injected noise, card vs CPU: loss, ELBO terms, gradient norms
  train_sisr the SISR trainer built from configs/sisr_x4.json (full width,
             batch 16, 192^2, bf16 autocast) for 30 steps on seeded smooth
             HR batches: launches of one step (K5 x2, K6, K7), ms per step,
             peak memory, a device-time breakdown of one step, and the
             ELBO on a fixed batch with fixed noise before and after
  train_denoise_fp32  one denoising training step at 2x64^2 (full width)
             in fp32 with injected draws, card vs CPU: the synthetic
             trainer of configs/denoising_syn.json and the real-noise one
             of configs/denoising_real.json (pairs, MixUp, the residual
             prior): loss, ELBO terms, gradient norms
  train_denoise  the trainer built from configs/denoising_syn.json as it
             stands (full width, batch 16, 128^2, bf16 autocast) for 30
             steps on seeded smooth images: ms per step, peak memory, a
             device-time breakdown of one step, the idle share, and the
             ELBO on a fixed batch with fixed draws before and after; then
             10 steps of configs/denoising_real.json, ms per step.  The
             model is built with conv_impl='torch', as the JAX trainer
             forces plain convolutions: no kernel of the package launches

Every main-path phase (serve, serve_odd, ops, real, fp32, probe,
train_sisr) zeroes the
launch counters, drives its path once and reads them; it fails if a kernel
of its path did not launch.  The line before the card's line is one JSON
object with the kernels' numbers: times and errors from the syn weights
in bf16 (K1-K4, K8 on 32-row slabs) or at the training shape in f32
(K5-K7), and each kernel's
launches in the one run of the path it serves
(``launches_path``; every path's count is in ``launches_by_path``).  K1-K4
and K8, their plain versions and library calls are timed with L2 flushed
before each launch (``ms``; the back-to-back time is ``warm_ms``), K5-K7
back to back; a kernel that reads under its bound fails.  K2's and K3's
``library_ms`` is a library route of several calls (cuDNN and PyTorch,
``library`` names how many), as no one call computes their function.  The
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
              "real", "fp32", "psnr", "probe", "sisr_fwd", "train_fp32",
              "train_sisr", "train_denoise_fp32", "train_denoise")
SYN_CKPT = ROOT / "model_zoo" / "virnet_denoising_syn_demo.pth"
REAL_CKPT = ROOT / "model_zoo" / "virnet_denoising_real_demo.pth"
SISR_CKPT = ROOT / "model_zoo" / "virnet_sisr_x4_demo.pth"
SISR_CONFIG = ROOT / "configs" / "sisr_x4.json"
DENOISE_CONFIGS = {"syn": ROOT / "configs" / "denoising_syn.json",
                   "real": ROOT / "configs" / "denoising_real.json"}

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
        path="serve_odd", source="virnet_tpu_torch/csrc/snet_levels.cu",
        uses="virnet_tpu_torch/csrc/conv3x3_mid.cu (K1, the mid levels)",
        replaces="virnet_tpu/ops/pallas_conv.py:474 (dncnn_pair_fused)"),
    "dncnn_head_fused": dict(
        path="serve", source="virnet_tpu_torch/csrc/dncnn_head.cu",
        replaces="virnet_tpu/ops/pallas_conv.py:1289 (dncnn_head_fused "
                 "halo :1512, carry :1459)"),
    "conv3x3_tail_residual": dict(
        path="serve", source="virnet_tpu_torch/csrc/tail_residual.cu",
        replaces="virnet_tpu/ops/pallas_conv.py:841 "
                 "(conv3x3_tail_residual)"),
    "dncnn_head_fused_fp32": dict(
        path="fp32", counter="dncnn_head_fused",
        source="virnet_tpu_torch/csrc/snet_levels.cu",
        uses="virnet_tpu_torch/csrc/conv3x3_mid.cu (K1, the mid levels)",
        replaces="virnet_tpu/ops/pallas_conv.py:1289 (dncnn_head_fused "
                 "halo :1512, carry :1459), in fp32"),
    "dncnn_head_slabzero": dict(
        path="probe", source="virnet_tpu_torch/csrc/dncnn_head.cu",
        uses="fp32: virnet_tpu_torch/csrc/snet_levels.cu + conv3x3_mid.cu "
             "(K3's level chain on the slab view)",
        replaces="virnet_tpu/ops/pallas_conv.py:1183 "
                 "(_dncnn_head_kernel_slabzero; dncnn_head_fused "
                 "mode='slabzero', pallas_call :1412)"),
    "blur_valid": dict(
        path="train_sisr", source="virnet_tpu_torch/csrc/blur.cu",
        replaces="virnet_tpu/ops/pallas_blur.py:307 (_blur_pallas_valid), "
                 ":118 (_blur_mxu_valid)"),
    "blur_dx": dict(
        path="train_sisr", source="virnet_tpu_torch/csrc/blur.cu",
        replaces="virnet_tpu/ops/pallas_blur.py:237 (_blur_mxu_dx; fallback "
                 "_dx_blur :271)"),
    "blur_dw": dict(
        path="train_sisr", source="virnet_tpu_torch/csrc/blur.cu",
        replaces="virnet_tpu/ops/pallas_blur.py:180 (_blur_mxu_dw), "
                 ":374 (_blur_pallas_dw)"),
}
# the measurement a kernel's row of the last-but-two line is taken from:
# (results key, tag)
ROW_TAG = {name: (name, "train f32" if name.startswith("blur")
                  else "syn bf16") for name in KERNELS}
ROW_TAG["dncnn_head_fused_fp32"] = ("dncnn_head_fused", "syn fp32")


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


_FLUSH: list = []


def time_cold_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median ms of ``iters`` launches of ``fn``, each timed by its own
    pair of events right after 256 MB were written to the card, so that
    it finds its inputs in device memory and not in the 50 MB L2."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def check_bound(name, what, ms, b_ms):
    """A reading under the least time the card could take says that the
    count of bytes or operations, or the timer, is wrong."""
    if ms < b_ms:
        raise AssertionError(f"{name}: {what} read {ms:.4f} ms, under its "
                             f"bound of {b_ms:.4f} ms: the bound's count or "
                             f"the timer is wrong")


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
    x_odd8 = rand(8, 321, 481, 3)                # restore_images' batch
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
        kw = dict(lmin=math.log(1e-10), lmax=math.log(1e2))

        def bound(flops, nbytes):
            return bound_ms(flops, nbytes, peak, peaks)

        def entry(name, err, k_fn, p_fn, l_fn, flops, nbytes, iters,
                  cold=False, library="one call"):
            """Times of kernel, plain version and library call (or, where
            no one call computes the function, the library route named by
            ``library``); with ``cold`` each launch finds L2 flushed
            (``ms``), and the back-to-back times are kept as
            ``warm_ms``."""
            timer = time_cold_ms if cold else time_ms
            ms = timer(k_fn, iters)
            plain_ms = timer(p_fn, iters)
            lib_ms = None if l_fn is None else timer(l_fn, iters)
            b_ms, b_by = bound(flops, nbytes)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       flops=flops, bytes=nbytes, timing="cold L2" if cold
                       else "back to back",
                       library=None if l_fn is None else library)
            if cold:
                row.update(warm_ms=time_ms(k_fn, iters),
                           library_warm_ms=None if l_fn is None
                           else time_ms(l_fn, iters))
            log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                f" ms, bound {b_ms:.4f} ms ({b_by}), {row['timing']}"
                + (f"; warm: kernel {row['warm_ms']:.4f} ms, library "
                   f"{row['library_warm_ms']} ms" if cold else ""))
            check_bound(name, "the kernel", ms, b_ms)
            if cold and lib_ms is not None:
                check_bound(name, "the library call", lib_ms, b_ms)
            results.setdefault(name, {})[tag] = row

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
              2 * 9 * 64 * 64 * npx,
              2 * npx * 64 * esz + (w.numel() + b.numel()) * esz, 20,
              cold=True)

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
        lib_snet, lib_head, lib_calls = library_route(p, L, kw)
        entry("dncnn_fused", err, lambda: fc.dncnn_fused(*args2),
              lambda: fc.dncnn_fused_plain(*args2), lambda: lib_snet(xo),
              snet_flops * npx, npx * (3 + co) * esz + weights_b, 5,
              cold=True, library=f"library route, {lib_calls[0]} calls")
        results["dncnn_fused"][tag]["levels_ms"] = chain_levels(
            args2, p, False, kw)
        if label == "real" and dtype == torch.float32:
            results["dncnn_fused"][tag]["sigma_margin"] = sigma_margin(
                args2, got)
        del got
        # K2 at the batch Restorer.restore_images groups images into
        x8 = x_odd8.to(dtype)
        args8b = (x8, *args2[1:])
        got = fc.dncnn_fused(*args8b)
        torch.cuda.synchronize()
        err8 = check_close("dncnn_fused logits, 8x321x481", got,
                           fc.dncnn_fused_plain(*args8b), dtype)
        del got
        ms8 = time_cold_ms(lambda: fc.dncnn_fused(*args8b), 5)
        lib8 = time_cold_ms(lambda: lib_snet(x8), 5)
        b8_ms, b8_by = bound(snet_flops * 8 * npx,
                             8 * npx * (3 + co) * esz + weights_b)
        log(f"  dncnn_fused 8x321x481: kernel {ms8:.4f} ms, library route "
            f"{lib8:.4f} ms, bound {b8_ms:.4f} ms ({b8_by}), cold L2")
        check_bound("dncnn_fused 8x321x481", "the kernel", ms8, b8_ms)
        results["dncnn_fused"][tag]["batch8"] = dict(
            max_abs_err=err8, ms=ms8, library_ms=lib8, bound_ms=b8_ms,
            bound_by=b8_by)
        del x8, args8b

        # K3 at the gated batch
        xf = x_flag.to(dtype)
        args3 = args2[1:]
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
                                                **kw), lambda: lib_head(xf),
              (snet_flops + 2 * 9 * (3 + co) * cf) * npx,
              npx * (3 + co + cf) * esz + weights_b
              + (p["wh"].numel() + cf) * esz, 5, cold=True,
              library=f"library route, {lib_calls[1]} calls")
        if dtype == torch.float32:
            results["dncnn_head_fused"][tag]["levels_ms"] = chain_levels(
                (xf, *args3), p, True, kw)
        elif label == "syn":
            # the level chain in bf16 with snet_last's sigma + head mode: a
            # measurement beside K3 bf16's one launch, routed nowhere
            def chain():
                return fc._snet_chain(True, xf, *args3, p["wh"], p["bh"],
                                      0.25, kw["lmin"], kw["lmax"])
            hc, sc = chain()
            torch.cuda.synchronize()
            check_close("level chain bf16 (measurement only) head", hc,
                        head_ref, dtype)
            check_close("level chain bf16 (measurement only) sigma", sc,
                        sig_ref, dtype, kind="sigma")
            del hc, sc
            c_ms = time_cold_ms(chain, 5)
            k3_ms = results["dncnn_head_fused"][tag]["ms"]
            log(f"  level chain bf16, sigma + head mode, cold: {c_ms:.4f} ms "
                f"against K3 bf16's one launch {k3_ms:.4f} ms "
                f"({c_ms / k3_ms:.3f}x)")
            results["dncnn_head_fused"][tag]["chain_bf16"] = dict(
                ms=c_ms, k3_ms=k3_ms,
                levels_ms=chain_levels((xf, *args3), p, True, kw))

        # K8 at the gated batch: 8-, 16- and 32-row slabs against the
        # plain version, to K3's tolerances; the rows farther than L+3 from
        # every slab edge also against K3's output one row up, at the same
        # bound (K8 runs K3's device code on the slab view, so the two sum
        # in one order there but for the halo's rows; the largest
        # difference is printed); K3's operations and bytes
        args8 = (xf, *args3, p["wh"], p["bh"])
        for rows in (8, 16, 32):
            h8, s8 = fc.dncnn_head_slabzero(*args8, rows=rows, **kw)
            torch.cuda.synchronize()
            h8_ref, s8_ref = fc.dncnn_head_slabzero_plain(*args8, rows=rows,
                                                          **kw)
            e = max(
                check_close(f"dncnn_head_slabzero r{rows} head", h8, h8_ref,
                            dtype),
                check_close(f"dncnn_head_slabzero r{rows} sigma", s8, s8_ref,
                            dtype, kind="sigma"))
            if rows == 32:
                err = e
            del h8_ref, s8_ref
            if rows != 32:
                del h8, s8
        far = [r for r in range(256) if L + 3 <= r % 32 < 32 - (L + 3)]
        up = [r - 1 for r in far]
        far_err = dict(
            head=check_close(f"dncnn_head_slabzero r32 head, {len(far)} rows "
                             f"far from slab edges vs K3 one row up",
                             h8[:, far], head[:, up], dtype),
            sigma=check_close("dncnn_head_slabzero r32 sigma, the same rows "
                              "vs K3", s8[:, far], sig[:, up], dtype,
                              kind="sigma"))
        del h8, s8, head, sig, head_ref, sig_ref
        # the library route on the shifted slab view (the shift made once,
        # outside the timing: the kernels read x one row up in place)
        xs8 = fc.slab_rows_up(xf, 32).contiguous()
        entry("dncnn_head_slabzero", err,
              lambda: fc.dncnn_head_slabzero(*args8, rows=32, **kw),
              lambda: fc.dncnn_head_slabzero_plain(*args8, rows=32, **kw),
              lambda: lib_head(xs8),
              (snet_flops + 2 * 9 * (3 + co) * cf) * npx,
              npx * (3 + co + cf) * esz + weights_b
              + (p["wh"].numel() + cf) * esz, 3, cold=True,
              library=f"library route on the shifted slab view, "
                      f"{lib_calls[1]} calls")
        del xs8
        # K3 - K8: K8 runs K3's device code on slabs.  In bf16 (one launch
        # of dncnn_head.cu) K8's tiles span a slab's rows up to 32 and
        # recompute only the column halo, so at r=32 the difference is what
        # K3's row halo costs; in fp32 both are the level chain, which
        # recomputes nothing, so it should be about 0
        by_rows = {r: time_cold_ms(lambda: fc.dncnn_head_slabzero(
            *args8, rows=r, **kw), 3) for r in (8, 16, 32)}
        k3_ms = results["dncnn_head_fused"][tag]["ms"]
        what = ("K3 - K8: the cost of K3's row halo (one device code, "
                "dncnn_head.cu)" if dtype == torch.bfloat16 else
                "K3 - K8: the level chain on images against on slabs "
                "(nothing recomputed in either)")
        results["dncnn_head_slabzero"][tag].update(
            ms_by_rows=by_rows, k3_minus_k8_ms={
                r: k3_ms - ms for r, ms in by_rows.items()},
            k3_minus_k8_means=what, far_rows_vs_k3=far_err)
        log("  dncnn_head_slabzero by slab rows, cold: " + ", ".join(
            f"r{r} {ms:.4f} ms ({k3_ms - ms:+.4f})"
            for r, ms in by_rows.items()) + f"; {what}")

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
              2 * 9 * 96 * 3 * npx,
              npx * (96 * esz + 3 * 4 + 3 * 4) + (wt.numel() + 3) * esz, 10,
              cold=True)



def library_route(p, L, kw, slope=0.25):
    """The SNet (K2's function) and the SNet + sigma epilogue + head (K3's)
    through cuDNN and PyTorch in the activation dtype, NCHW-shaped and
    channels_last in memory as the conv_impl='torch' route runs them:
    yardsticks timed here and used nowhere in the port.  Returns the two
    functions of NHWC x and how many PyTorch calls each makes."""
    import torch.nn.functional as F

    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    w1, wl, wh = oihw(p["w1"]), oihw(p["wl"]), oihw(p["wh"])
    wms = [oihw(w) for w in p["wms"]]

    def snet(x):
        y = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), w1, p["b1"],
                                  padding=1), slope)
        for w, b in zip(wms, p["bms"]):
            y = F.leaky_relu(F.conv2d(y, w, b, padding=1), slope)
        return F.conv2d(y, wl, p["bl"], padding=1)

    def head(x):
        logits = snet(x)
        sig = torch.exp(torch.clamp(logits.float(), kw["lmin"],
                                    kw["lmax"])).to(x.dtype)
        ext = torch.cat([x.permute(0, 3, 1, 2), torch.sqrt(sig)], 1)
        return F.conv2d(ext, wh, p["bh"], padding=1), sig

    snet_calls = 2 * (L + 1) + 1
    return snet, head, (snet_calls, snet_calls + 7)


def chain_levels(args, p, head, kw, iters=5):
    """Cold ms of each launch of the level chain (K2, or K3 with ``head``)
    alone, on the inputs of ``args`` (x, w1, b1, wms, bms, wl, bl): the
    breakdown that says which level holds the chain back."""
    from virnet_tpu_torch.ops import fused_conv as fc

    x = args[0]
    n, h, w, _ = x.shape
    code, st = fc._dtype_code(x), fc._stream(x)
    co = p["wl"].shape[3]
    cf = p["wh"].shape[3] if head else 0
    L = p["wms"].shape[0]
    y = torch.empty((n, h, w, 64), dtype=x.dtype, device=x.device)
    out0 = torch.empty((n, h, w, cf if head else co), dtype=x.dtype,
                       device=x.device)
    out1 = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)

    def conv1():
        fc._ret(fc._fn("vt_snet_conv1")(
            x.data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(),
            y.data_ptr(), n, h, w, 0, code, 0.25, st), "vt_snet_conv1")

    def mid():
        fc.conv3x3_mid(y, p["wms"][0], p["bms"][0], 0.25)

    def last():
        fc._ret(fc._fn("vt_snet_last")(
            y.data_ptr(), x.data_ptr(), p["wl"].data_ptr(),
            p["bl"].data_ptr(), p["wh"].data_ptr() if head else None,
            p["bh"].data_ptr() if head else None, out0.data_ptr(),
            out1.data_ptr() if head else None, n, h, w, co, cf, int(head),
            0, code, kw["lmin"], kw["lmax"], st), "vt_snet_last")

    conv1()
    out = dict(snet_conv1=time_cold_ms(conv1, iters),
               k1_each=time_cold_ms(mid, iters),
               snet_last=time_cold_ms(last, iters))
    out["k1_all"] = L * out["k1_each"]
    log(f"  level chain ({'K3 sigma + head' if head else 'K2 logits'}), each "
        f"launch alone, cold: snet_conv1 {out['snet_conv1']:.4f} ms, K1 "
        f"{out['k1_each']:.4f} ms x {L}, snet_last {out['snet_last']:.4f} ms")
    return out


def sigma_margin(args2, got):
    """Where fp32 sigma's margin goes, at the real weights and 321x481: the
    new K2's absolute logits error against its plain version on the card
    (cuDNN), and the spread between two correct f32 orders, the plain
    version on the card against the plain version on the CPU.  sigma =
    exp(logits), so a relative sigma error is an absolute logits error."""
    from virnet_tpu_torch.ops import fused_conv as fc

    card = fc.dncnn_fused_plain(*args2)
    cpu = fc.dncnn_fused_plain(*[a.cpu() for a in args2])
    out = dict(k2_vs_plain=max_err(got, card),
               plain_card_vs_cpu=max_err(card.cpu(), cpu),
               k2_vs_plain_cpu=max_err(got.cpu(), cpu),
               logits_absmax=float(cpu.abs().max()))
    log(f"  sigma margin (real fp32, 321x481, logits): K2 vs plain on the "
        f"card {out['k2_vs_plain']:.3g}, plain card vs plain CPU "
        f"{out['plain_card_vs_cpu']:.3g}, K2 vs plain CPU "
        f"{out['k2_vs_plain_cpu']:.3g} (|logits| <= "
        f"{out['logits_absmax']:.3g}; sigma rtol 1e-5)")
    return out


def bound_ms(flops, nbytes, peak_flops, peaks):
    t_ops, t_mem = flops / peak_flops * 1e3, nbytes / peaks["bytes"] * 1e3
    return max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes"


def check_abs(name, got, want, atol):
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = max_err(got, want)
    ok = err <= atol
    log(f"  {name}: max diff {err:.3g} (atol {atol:.3g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"({err} vs atol {atol})")
    return err


def any_c_blur_build():
    """Start nvcc on a copy of csrc/blur.cu whose images (C = 3) take the
    any-C build of K5/K6 instead of the C = 3 builds; returns the process
    and a function that waits for it and gives its vt_blur_valid and
    vt_blur_dx."""
    import ctypes

    from virnet_tpu_torch.ops import _build
    from virnet_tpu_torch.ops import fused_conv as fc

    src = (_build.CSRC / "blur.cu").read_text()
    pat = "(C != 3 ? 0 :"
    if src.count(pat) != 1:
        raise RuntimeError(f"blur.cu: {pat!r} occurs {src.count(pat)} "
                           f"times, expected once")
    d = _build.build_dir() / "blur_any_c"
    d.mkdir(parents=True, exist_ok=True)
    (d / "blur.cu").write_text(src.replace(pat, "(true ? 0 :"))
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(d / "libblur.so"), str(d / "blur.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def fns():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the any-C blur.cu:\n{out}")
        lib = ctypes.CDLL(str(d / "libblur.so"))
        got = {}
        for sym in ("vt_blur_valid", "vt_blur_dx"):
            f = getattr(lib, sym)
            f.argtypes, f.restype = fc._SIGNATURES[sym][1], ctypes.c_int
            got[sym] = f
        return got
    return proc, fns


def phase_blur_kernels(report, peaks):
    proc, any_c = any_c_blur_build()
    try:
        blur_kernels(report, peaks, any_c)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def blur_kernels(report, peaks, any_c):
    """K5-K7 against their plain versions on the card in f32.  Bounds:
    forward and dX atol 2e-5 on inputs in [0, 1) with taps summing to 1
    (the same k*k products summed in another order), dW 1e-5 of max|dW| (a
    sum of H*W*C products per tap).  K6 and K7 run twice: equal bits.  At
    the training shape K5 and K6 are also timed through the any-C build
    (`any_c_ms`), which must give the same bits as the C = 3 build."""
    import torch.nn.functional as F

    from virnet_tpu_torch.ops import blur
    from virnet_tpu_torch.ops import fused_conv as fc
    from virnet_tpu_torch.ops.degrade import blur_per_sample

    dev = torch.device("cuda")
    results = report.setdefault("kernels", {})
    gen = torch.Generator(device="cpu").manual_seed(1)

    def case(n, h, w, c, k):
        x = torch.rand(n, h, w, c, generator=gen).to(dev)
        g = torch.rand(n, h, w, c, generator=gen).to(dev)
        kern = torch.rand(n, k, k, generator=gen)
        return x, g, (kern / kern.sum((1, 2), keepdim=True)).to(dev)

    for label, (n, h, w, c, k) in (("train", (16, 192, 192, 3, 21)),
                                   ("eval", (1, 512, 512, 3, 21)),
                                   ("awkward", (2, 13, 17, 2, 5))):
        tag = f"{label} f32"
        log(f"[kernels {tag}] blur {n}x{h}x{w}x{c}, k={k}")
        x, g, kern = case(n, h, w, c, k)
        xp = blur.pad_hw(x, k // 2, "reflect")
        out, dxp, dw = (blur.blur_valid(xp, kern), blur.blur_dx(g, kern),
                        blur.blur_dw(xp, g))
        torch.cuda.synchronize()
        dw_ref = blur.blur_dw_plain(xp, g)
        errs = dict(
            blur_valid=check_abs("blur_valid", out,
                                 blur.blur_valid_plain(xp, kern), 2e-5),
            blur_dx=check_abs("blur_dx", dxp, blur.blur_dx_plain(g, kern),
                              2e-5),
            blur_dw=check_abs("blur_dw", dw, dw_ref,
                              1e-5 * float(dw_ref.abs().max())))
        if not (torch.equal(blur.blur_dx(g, kern), dxp)
                and torch.equal(blur.blur_dw(xp, g), dw)):
            raise AssertionError(f"{tag}: blur_dx or blur_dw gave other "
                                 f"bits on a second run")
        log("  blur_dx, blur_dw: a second run gives the same bits")

        # one library call per function (timed here, used nowhere else):
        # a grouped convolution with one group per (sample, channel)
        hp, wp = h + k - 1, w + k - 1
        xp_l = xp.permute(0, 3, 1, 2).reshape(1, n * c, hp, wp).contiguous()
        g_l = g.permute(0, 3, 1, 2).reshape(1, n * c, h, w).contiguous()
        w_l = kern.repeat_interleave(c, 0).unsqueeze(1).contiguous()
        libs = dict(
            blur_valid=lambda: F.conv2d(xp_l, w_l, groups=n * c),
            blur_dx=lambda: F.conv_transpose2d(g_l, w_l, groups=n * c),
            blur_dw=lambda: torch.nn.grad.conv2d_weight(
                xp_l, w_l.shape, g_l, groups=n * c).view(n, c, k, k).sum(1))
        if label == "train":
            lib_dw = libs["blur_dw"]()
            check_abs("library dW vs plain (the yardstick computes the same "
                      "function)", lib_dw, dw_ref,
                      1e-4 * float(dw_ref.abs().max()))
        kerns = dict(blur_valid=lambda: blur.blur_valid(xp, kern),
                     blur_dx=lambda: blur.blur_dx(g, kern),
                     blur_dw=lambda: blur.blur_dw(xp, g))
        plains = dict(blur_valid=lambda: blur.blur_valid_plain(xp, kern),
                      blur_dx=lambda: blur.blur_dx_plain(g, kern),
                      blur_dw=lambda: blur.blur_dw_plain(xp, g))
        # each input read once, each output written once; 2 FLOPs per tap
        # and output (forward) or per tap and cotangent element (dX, dW:
        # the products with the zero halo around the cotangent are not
        # work the function needs)
        work = dict(
            blur_valid=(2 * n * c * h * w * k * k,
                        4 * (xp.numel() + kern.numel() + out.numel())),
            blur_dx=(2 * n * c * h * w * k * k,
                     4 * (g.numel() + kern.numel() + dxp.numel())),
            blur_dw=(2 * n * c * h * w * k * k,
                     4 * (xp.numel() + g.numel() + dw.numel())))
        for name in ("blur_valid", "blur_dx", "blur_dw"):
            small = label == "awkward"
            ms = time_ms(kerns[name], 20)
            plain_ms = time_ms(plains[name], 2 if not small else 5, warmup=1)
            lib_ms = time_ms(libs[name], 10)
            b_ms, b_by = bound_ms(*work[name], peaks["fp32"], peaks)
            log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            check_bound(f"{name} {tag}", "the kernel", ms, b_ms)
            results.setdefault(name, {})[tag] = dict(
                max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                flops=work[name][0], bytes=work[name][1])

        if label != "train":
            continue
        # the any-C build on the same inputs: the same sums in the same
        # order, so the same bits; what the C = 3 builds' constant shared
        # row is worth
        saved = {sym: fc._fn(sym) for sym in ("vt_blur_valid", "vt_blur_dx")}
        try:
            fc._FNS.update(any_c())
            if not (torch.equal(blur.blur_valid(xp, kern), out)
                    and torch.equal(blur.blur_dx(g, kern), dxp)):
                raise AssertionError("the any-C build of K5/K6 gave other "
                                     "bits than the C = 3 build")
            for name in ("blur_valid", "blur_dx"):
                ms = time_ms(kerns[name], 20)
                results[name][tag]["any_c_ms"] = ms
                log(f"  {name}: any-C build {ms:.4f} ms (C = 3 build "
                    f"{results[name][tag]['ms']:.4f} ms)")
        finally:
            fc._FNS.update(saved)

        # the public op: both pad modes, correlation and convolution, value
        # and gradients (K5 forward, K6 + K7 backward) against autograd of
        # the plain op
        for pad_mode, correlate in (("reflect", True), ("symmetric", False)):
            xk = x.clone().requires_grad_()
            kk = kern.clone().requires_grad_()
            got = blur_per_sample(xk, kk, correlate=correlate,
                                  pad_mode=pad_mode)
            d_got = torch.autograd.grad((got * g).sum(), (xk, kk))
            xr = x.clone().requires_grad_()
            kr = kern.clone().requires_grad_()
            want = blur.blur_valid_plain(
                blur.pad_hw(xr, k // 2, pad_mode),
                kr if correlate else kr.flip(-2, -1))
            d_want = torch.autograd.grad((want * g).sum(), (xr, kr))
            what = f"blur_per_sample {pad_mode}/" + (
                "correlate" if correlate else "convolve")
            check_abs(what, got.detach(), want.detach(), 2e-5)
            check_abs(what + " dX", d_got[0], d_want[0], 2e-5)
            check_abs(what + " dW", d_got[1], d_want[1],
                      1e-5 * float(d_want[1].abs().max()))


# kernel-name keys of each group, the first match wins
GROUPS = (("K3/K8 bf16 dncnn_head.cu", ("dncnn_head_",)),
          ("K2/K3-fp32/K8-fp32 level kernels snet_levels.cu",
           ("snet_conv1", "snet_last")),
          ("K4 tail_residual.cu", ("tail_kernel",)),
          ("K1 conv3x3_mid.cu", ("conv3x3_mid_",)),
          ("library convolutions", ("conv", "cudnn", "xmma", "gemm",
                                    "cutlass", "implicit")))
TRAIN_GROUPS = (
    ("K5 blur_valid", ("blur_valid_kernel",)),
    ("K6 blur_dx", ("blur_dx_kernel",)),
    ("K7 blur_dw", ("blur_dw_partial", "blur_dw_reduce")),
    ("optimizer", ("multi_tensor", "adam", "foreach", "lpnorm")),
    ("cuDNN layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("cuDNN backward", ("dgrad", "wgrad", "bwd", "backward", "bprop")),
    ("cuDNN forward", ("cudnn", "xmma", "implicit", "conv", "fprop",
                       "cutlass")),
    ("matmul", ("gemm", "gemv", "cublas")))


def phase_profile(fn, report, key, what, groups=GROUPS, iters=2, top_ops=6,
                  rest="other"):
    """Device time of ``fn()`` by kernel group (``rest`` names the kernels
    no group claims), from torch.profiler (CUPTI), and the share of the
    wall time the device was idle (the profiler's own overhead counts as
    idle)."""
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
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / iters)
    if not kernels:
        log("  device time: not measured (the profiler saw no kernels)")
        report[key] = None
        return
    by_group: dict = {}
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in groups
                      if any(k in low for k in keys)), rest)
        by_group[group] = by_group.get(group, 0.0) + ms
    busy = sum(kernels.values())
    log(f"  per {what}: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {ms:.3f} ms ({ms / busy:.1%} of device time)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:8.3f} ms  {name[:90]}")
    ops = sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                   e.count // iters) for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0), key=lambda r: -r[1])
    for op, ms, count in ops[:top_ops]:
        log(f"    {ms:8.3f} ms  {op} x{count} (torch op, own kernels)")
    report[key] = dict(wall_ms=wall_ms, busy_ms=busy, groups=by_group,
                       idle_share=1 - busy / wall_ms, kernels=kernels,
                       torch_ops=ops)


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


def rel_err(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def sisr_noise(n, hr, sf, kappa0, seed, device):
    """Injected draws for one SISR training step (the synthesis draws and
    the ELBO's), made on the CPU from a seed so that two devices get the
    same numbers."""
    g = torch.Generator().manual_seed(seed)
    lr = hr // sf

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    noise = dict(
        synth=dict(lam1=u(0.2, float(sf), n), lam2_u=u(0, 1, n),
                   iso_u=u(0, 1, n), theta=u(0, math.pi, n),
                   nlevel=u(0.01 / 255, 15 / 255, n),
                   noise=torch.randn(n, lr, lr, 3, generator=g)),
        elbo=dict(gamma_draw=torch._standard_gamma(
                      torch.full((n, 2), kappa0 - 1.0), generator=g),
                  rho_eps=torch.randn(n, generator=g),
                  z_eps=torch.randn(n, hr, hr, 3, generator=g)))
    return {k: {kk: t.to(device) for kk, t in v.items()}
            for k, v in noise.items()}


def smooth_batch(rng, n, size) -> np.ndarray:
    return np.stack([smooth_image(rng, size, size) for _ in range(n)])


def phase_probe(report, launches):
    """The A/B entry point of the fused prologue at the flagship shape
    (denoising-syn preset at full width, random weights, bf16, 32x256^2):
    one apply of each fused variant with the counters zeroed just before
    it, then interleaved timings."""
    from virnet_tpu_torch.cli import bench_fused_head

    variants = ["unfused", "halo", "slabzero:r8", "slabzero:r16",
                "slabzero:r32"]
    log(f"[probe] cli.bench_fused_head.run {variants}, 32x256x256 bf16")
    res = bench_fused_head.run(variants, batch=32, size=256, reps=3, chain=4,
                               log=lambda m: log("  " + m))
    want = {"unfused": {},
            "halo": {"dncnn_head_fused": 1, "conv3x3_tail_residual": 1}}
    for v in variants[2:]:
        want[v] = {"dncnn_head_slabzero": 1, "conv3x3_tail_residual": 1}
    for v, counts in want.items():
        if res[v]["launches"] != counts:
            raise AssertionError(f"probe: one apply of {v} launched "
                                 f"{res[v]['launches']}, expected {counts}")
    launches["probe"] = res["slabzero:r32"]["launches"]
    launches["probe_halo"] = res["halo"]["launches"]
    halo = res["halo"]["best_ms"]
    for v in variants:
        r = res[v]
        extra = ("" if not v.startswith("slabzero") else
                 f", halo - {v} {halo - r['best_ms']:+.2f} ms (K8 is K3's "
                 f"kernel on slabs)")
        log(f"  {v}: best {r['best_ms']:.2f} ms per apply, "
            f"{r['mp_per_s']:.2f} MP/s, reps "
            f"{[round(m, 2) for m in r['ms']]}{extra}")
    report["probe"] = res


def phase_sisr_fwd(report):
    """VIRNetSR with the x4 demo weights (strict load), card vs CPU in
    fp32: mu atol 1e-4, kinfo and sigma rtol 1e-4 (the same function, sums
    in another order)."""
    from virnet_tpu_torch.convert import load_pth
    from virnet_tpu_torch.models import build_model

    sd = load_pth(SISR_CKPT)
    x = torch.from_numpy(np.random.default_rng(3).random(
        (4, 48, 48, 3), dtype=np.float32))
    outs = []
    for dev in ("cpu", "cuda"):
        model = build_model("sisr")
        model.load_state_dict(sd, strict=True)
        model = model.to(dev).eval()
        with torch.inference_mode():
            outs.append([t.float().cpu() for t in model(x.to(dev), 4)])
    (mu_c, k_c, s_c), (mu_g, k_g, s_g) = outs
    if tuple(mu_g.shape) != (4, 192, 192, 3):
        raise AssertionError(f"sisr_fwd: mu shape {tuple(mu_g.shape)}")
    e_mu = max_err(mu_g, mu_c)
    e_k = float(((k_g - k_c).abs() / k_c.abs().clamp_min(1e-3)).max())
    e_s = float(((s_g - s_c).abs() / s_c.abs()).max())
    log(f"  mu max diff {e_mu:.3g} (atol 1e-4), kinfo max rel diff "
        f"{e_k:.3g}, sigma max rel diff {e_s:.3g} (rtol 1e-4)")
    report["sisr_fwd"] = dict(mu_abs=e_mu, kinfo_rel=e_k, sigma_rel=e_s)
    if not (e_mu <= 1e-4 and e_k <= 1e-4 and e_s <= 1e-4):
        raise AssertionError("sisr_fwd: card forward disagrees with the CPU")


def sisr_config(**overrides) -> dict:
    from virnet_tpu_torch.config import load_config

    cfg = load_config(SISR_CONFIG)
    cfg["save_dir"] = str(ROOT / "build" / "chip_smoke_sisr")
    cfg.update(overrides)
    return cfg


def phase_train_fp32(report):
    """One run_step at 2x96^2, full width, fp32, injected noise, on the
    card and on the CPU: loss and every ELBO term rtol 1e-4, per-subnet
    gradient norms rtol 1e-3 (cuDNN's and oneDNN's sums differ in order
    through ~60 conv layers)."""
    from virnet_tpu_torch.cli.train_sisr import build_trainer

    cfg = sisr_config(batch_size=2, hr_size=96, mixed_precision=False)
    hr = smooth_batch(np.random.default_rng(4), 2, 96)
    outs = {}
    for dev in ("cpu", "cuda"):
        trainer = build_trainer(cfg, device=dev)
        noise = sisr_noise(2, 96, cfg["sf"], cfg["kappa0"], 5, dev)
        out = trainer.run_step(hr, 0, noise)
        outs[dev] = {k: float(v) for k, v in out.items()}
        del trainer
    worst = {}
    for k, want in outs["cpu"].items():
        tol = 1e-3 if k.startswith("gnorm") else 1e-4
        worst[k] = rel_err(outs["cuda"][k], want)
        log(f"  {k}: card {outs['cuda'][k]:.7g}, CPU {want:.7g}, rel diff "
            f"{worst[k]:.3g} (rtol {tol:g})")
        if not (math.isfinite(outs["cuda"][k]) and worst[k] <= tol):
            raise AssertionError(f"train_fp32: {k} disagrees with the CPU")
    report["train_fp32"] = dict(card=outs["cuda"], cpu=outs["cpu"],
                                rel=worst)


def profile_step(step_fn, report, key, ms):
    """Device-time breakdown of two profiled training steps by
    TRAIN_GROUPS, and the idle share against ``ms``, the median of the
    unprofiled steps (None when the profiler saw no kernel)."""
    phase_profile(step_fn, report, key, "step", groups=TRAIN_GROUPS, iters=2,
                  top_ops=12, rest="elementwise, copies, reductions (PyTorch)")
    prof = report.get(key)
    if not prof:
        return None
    # the profiler slows the host down, so the busy time of the two
    # profiled steps is held against the median of the unprofiled
    # steps: two different sets of steps.  A negative share says that
    # they do not belong together.
    idle = 1 - prof["busy_ms"] / ms
    log(f"  device busy {prof['busy_ms']:.2f} ms (2 profiled steps) of "
        f"the {ms:.2f} ms unprofiled step (median of other steps): "
        f"idle share {idle:.3f}")
    if idle < 0:
        log("  WARNING: the profiled steps kept the device busy longer "
            "than an unprofiled step lasts: the two do not describe the "
            "same work, and this idle share says nothing")
    return idle


def timed_steps(run_step, batch, steps, what):
    """``steps`` training steps on fresh batches, each timed on the host
    clock around a synchronise; fails on a non-finite scalar.  Returns
    (times in ms, the last step's scalars)."""
    times, last = [], {}
    for _ in range(steps):
        x = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_step(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        last = {k: float(v) for k, v in out.items()}
        bad = [k for k, v in last.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{what}: non-finite {bad}")
    return times, last


def denoise_trainer(kind, device="cuda", **overrides):
    """The trainer of configs/denoising_{syn,real}.json through its CLI's
    build_trainer."""
    import importlib

    from virnet_tpu_torch.config import load_config

    cli = importlib.import_module(
        f"virnet_tpu_torch.cli.train_denoising_{kind}")
    cfg = load_config(DENOISE_CONFIGS[kind])
    cfg["save_dir"] = str(ROOT / "build" / f"chip_smoke_denoise_{kind}")
    cfg.update(overrides)
    return cli.build_trainer(cfg, device=device)


def denoise_draws(kind, n, size, seed, device):
    """Injected draws for one denoising step, made on the CPU from a seed
    so that two devices get the same numbers: the synthesis draws
    (synthetic) or the MixUp permutation and coefficients (real)."""
    g = torch.Generator().manual_seed(seed)
    if kind == "real":
        gam = torch._standard_gamma(torch.full((2, n), 0.6), generator=g)
        return dict(mixup=(torch.randperm(n, generator=g).to(device),
                           (gam[0] / gam.sum(0)).to(device)))

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g)

    synth = dict(center=u(0, size, n, 2),
                 scale=u(size / 4, size / 4 * 3, n, 1, 1),
                 updown=u(0, 75 / 255, n, 2),
                 eps=torch.randn(n, size, size, 3, generator=g))
    return dict(synth={k: t.to(device) for k, t in synth.items()})


def denoise_batch(kind, rng, n, size):
    """Seeded smooth clean images; for 'real' the (noisy, gt) pair with
    Gaussian noise of a per-image level in [5, 30]/255, clipped."""
    gt = smooth_batch(rng, n, size)
    if kind == "syn":
        return gt
    level = rng.uniform(5 / 255, 30 / 255, (n, 1, 1, 1))
    noisy = np.clip(gt + level * rng.standard_normal(gt.shape), 0, 1)
    return noisy.astype(np.float32), gt


def phase_train_denoise_fp32(report):
    """One run_step at 2x64^2, full width, fp32, injected draws, on the
    card and on the CPU, for both trainers: loss and every ELBO term rtol
    1e-4, per-subnet gradient norms rtol 1e-3 (cuDNN's and oneDNN's sums
    differ in order through ~60 conv layers)."""
    report["train_denoise_fp32"] = {}
    for kind in ("syn", "real"):
        batch = denoise_batch(kind, np.random.default_rng(8), 2, 64)
        outs = {}
        for dev in ("cpu", "cuda"):
            trainer = denoise_trainer(kind, dev, batch_size=2, patch_size=64,
                                      mixed_precision=False)
            out = trainer.run_step(batch, 0, denoise_draws(kind, 2, 64, 9,
                                                           dev))
            outs[dev] = {k: float(v) for k, v in out.items()}
            del trainer
        worst = {}
        for k, want in outs["cpu"].items():
            tol = 1e-3 if k.startswith("gnorm") else 1e-4
            worst[k] = rel_err(outs["cuda"][k], want)
            log(f"  {kind} {k}: card {outs['cuda'][k]:.7g}, CPU {want:.7g}, "
                f"rel diff {worst[k]:.3g} (rtol {tol:g})")
            if not (math.isfinite(outs["cuda"][k]) and worst[k] <= tol):
                raise AssertionError(
                    f"train_denoise_fp32: {kind} {k} disagrees with the CPU")
        report["train_denoise_fp32"][kind] = dict(
            card=outs["cuda"], cpu=outs["cpu"], rel=worst)


def phase_train_denoise(report, launches, steps=30, real_steps=10):
    """The denoising trainers at full width (batch 16, 128^2, bf16
    autocast) through their CLIs' build_trainer and
    DenoiseTrainer.run_step."""
    from virnet_tpu_torch.ops import fused_conv as fc

    out_report = {}
    for kind, n_steps in (("syn", steps), ("real", real_steps)):
        trainer = denoise_trainer(kind)
        tc = trainer.cfg
        log(f"[train_denoise {kind}] n_feat {tc.n_feat}, dep_S {tc.dep_S}, "
            f"sigma_chn {tc.sigma_chn}, batch {tc.batch_size}, patch "
            f"{tc.patch_size}^2, real {trainer.real}, bf16 autocast "
            f"{tc.mixed_precision}, device {trainer.device}")
        width = dict(syn=((96, 192, 288), 5), real=((96, 160, 224, 288), 8))
        if ((tuple(tc.n_feat), tc.dep_S) != width[kind]
                or (tc.batch_size, tc.patch_size) != (16, 128)
                or not tc.mixed_precision or trainer.device.type != "cuda"):
            raise AssertionError(f"train_denoise: {kind} is not the "
                                 f"full-width configuration")
        rng = np.random.default_rng(10)
        pool = denoise_batch(kind, rng, 64, tc.patch_size)
        pool = [torch.from_numpy(t).cuda() for t in
                (pool if kind == "real" else (pool,))]

        def batch():
            idx = torch.from_numpy(rng.choice(64, tc.batch_size,
                                              replace=False)).cuda()
            picked = tuple(t[idx] for t in pool)
            return picked if kind == "real" else picked[0]

        fixed = batch()
        draws = denoise_draws(kind, tc.batch_size, tc.patch_size, 11, "cuda")
        before = float(trainer.loss_and_grads(fixed, 0, draws)[0])
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launches()
        trainer.run_step(batch(), 0)
        torch.cuda.synchronize()
        counts = dict(fc.LAUNCHES)
        launches[f"train_denoise_{kind}"] = counts
        log(f"  launches in one step {counts}")
        if any(counts.values()):
            raise AssertionError("train_denoise: the step is built on plain "
                                 "convolutions and launches no kernel of the "
                                 "package")
        times, last = timed_steps(lambda x: trainer.run_step(x, 0), batch,
                                  n_steps - 1, f"train_denoise {kind}")
        ms = float(np.median(times[-20:] if kind == "syn" else times[2:]))
        peak = torch.cuda.max_memory_allocated()
        log(f"  {ms:.2f} ms per step (median of the last "
            f"{min(20, len(times)) if kind == 'syn' else len(times) - 2}), "
            f"{1e3 / ms:.2f} steps/s, peak memory {peak / 2 ** 30:.2f} GiB")
        log(f"  step {trainer.step}: loss {last['loss']:.4g}, lh "
            f"{last['lh']:.4g}, KLG {last['kl_gauss']:.4g}, KLIG "
            f"{last['kl_ig']:.4g}, gnorm R/S {last['gnorm_r']:.4g}/"
            f"{last['gnorm_s']:.4g}")
        res = dict(ms_per_step=ms, steps_per_s=1e3 / ms, peak_bytes=peak,
                   step_ms=times, last=last, launches=counts)
        if kind == "syn":
            x = batch()
            res["idle_share"] = profile_step(
                lambda: trainer.run_step(x, 0), report,
                "train_denoise_profile", ms)
        after = float(trainer.loss_and_grads(fixed, 0, draws)[0])
        log(f"  ELBO on the fixed batch with fixed draws: {before:.6g} "
            f"before, {after:.6g} after {trainer.step} steps")
        res.update(elbo_before=before, elbo_after=after)
        out_report[kind] = res
        if not (math.isfinite(after) and after < before):
            raise AssertionError(f"train_denoise: the {kind} ELBO on the "
                                 f"fixed batch did not go down")
        del trainer, pool
    report["train_denoise"] = out_report


def phase_train_sisr(report, launches, steps=30):
    """The SISR trainer of configs/sisr_x4.json at full width (batch 16,
    192^2, bf16 autocast) through cli.train_sisr.build_trainer and
    SISRTrainer.run_step."""
    from virnet_tpu_torch.cli.train_sisr import build_trainer
    from virnet_tpu_torch.ops import fused_conv as fc

    cfg = sisr_config()
    trainer = build_trainer(cfg)
    tc = trainer.cfg
    log(f"[train_sisr] n_feat {tc.n_feat}, dep_S {tc.dep_S}, dep_K "
        f"{tc.dep_K}, batch {tc.batch_size}, HR {tc.hr_size}^2, sf {tc.sf}, "
        f"k {tc.k_size}, {tc.downsampler}, bf16 autocast "
        f"{tc.mixed_precision}, device {trainer.device}")
    if (tuple(tc.n_feat), tc.batch_size, tc.hr_size, tc.sf, tc.k_size) != (
            (96, 160, 224), 16, 192, 4, 21) or trainer.device.type != "cuda":
        raise AssertionError("train_sisr: not the full-width configuration")
    rng = np.random.default_rng(6)
    pool = torch.from_numpy(smooth_batch(rng, 64, tc.hr_size)).cuda()
    fixed = torch.from_numpy(smooth_batch(rng, tc.batch_size,
                                          tc.hr_size)).cuda()
    fixed_noise = sisr_noise(tc.batch_size, tc.hr_size, tc.sf, tc.kappa0, 7,
                             "cuda")

    def batch():
        return pool[torch.from_numpy(rng.choice(64, tc.batch_size,
                                                replace=False)).cuda()]

    def fixed_elbo():
        loss, _ = trainer.loss_and_grads(fixed, 0, fixed_noise)
        return float(loss)

    before = fixed_elbo()
    torch.cuda.reset_peak_memory_stats()

    fc.reset_launches()
    out = trainer.run_step(batch(), 0)
    torch.cuda.synchronize()
    counts = dict(fc.LAUNCHES)
    launches["train_sisr"] = counts
    log(f"  launches in one step {counts}, copies {dict(fc.COPIES)}")
    if (counts["blur_valid"], counts["blur_dx"], counts["blur_dw"]) != (
            2, 1, 1):
        raise AssertionError("train_sisr: one step must launch blur_valid "
                             "twice and blur_dx, blur_dw once each")

    times, last = timed_steps(lambda x: trainer.run_step(x, 0), batch,
                              steps - 1, "train_sisr")
    ms = float(np.median(times[-20:]))
    peak = torch.cuda.max_memory_allocated()
    log(f"  {ms:.2f} ms per step (median of the last 20), "
        f"{1e3 / ms:.2f} steps/s, peak memory {peak / 2 ** 30:.2f} GiB")
    log(f"  step {trainer.step}: loss {last['loss']:.4g}, lh {last['lh']:.4g}"
        f", KLR {last['kl_rnet']:.4g}, KLS {last['kl_snet']:.4g}, KLK "
        f"{last['kl_knet']:.4g}, gnorm R/S/K {last['gnorm_r']:.4g}/"
        f"{last['gnorm_s']:.4g}/{last['gnorm_k']:.4g}")
    x = batch()
    idle = profile_step(lambda: trainer.run_step(x, 0), report,
                        "train_profile", ms)
    after = fixed_elbo()
    log(f"  ELBO on the fixed batch with fixed noise: {before:.6g} before, "
        f"{after:.6g} after {trainer.step} steps")
    report["train_sisr"] = dict(
        ms_per_step=ms, steps_per_s=1e3 / ms, peak_bytes=peak,
        step_ms=times, elbo_before=before, elbo_after=after, last=last,
        launches=counts, copies=dict(fc.COPIES), idle_share=idle)
    if not (math.isfinite(after) and after < before):
        raise AssertionError("train_sisr: the ELBO on the fixed batch did "
                             "not go down")


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
        phase_blur_kernels(report, peaks)

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
        phase_profile(lambda: syn.restore_batch(x), report, "profile",
                      "forward")

    if "serve_odd" in phases:
        log("[serve_odd] restore_image 321x481 (K2: snet_conv1, K1 x3, "
            "snet_last; K4)")
        out_odd, launches["serve_odd"] = run_path(
            "serve_odd", lambda: syn.restore_image(odd),
            ("dncnn_fused", "conv3x3_mid", "conv3x3_tail_residual"))
        check_image("serve_odd", out_odd, (321, 481, 3))
        if launches["serve_odd"]["conv3x3_mid"] != 3:
            raise AssertionError("serve_odd: K2's chain must launch K1 once "
                                 "per mid level (3)")
        from virnet_tpu_torch.cli.bench_restore import time_image

        res = time_image(syn, odd, reps=20)
        report["serve_odd"] = dict(ms_per_image=res["median_ms"],
                                   min_ms=res["min_ms"])
        log(f"  {res['median_ms']:.2f} ms per image, median of 20 (least "
            f"{res['min_ms']:.2f}; host clock, copies to and from the card "
            f"included; cli/bench_restore)")

    if "ops" in phases:
        log("[ops] restore_image 321x481 on the per-op SNet route (K1)")
        syn_ops = Restorer("denoising-syn", ckpt_path=SYN_CKPT,
                           compute="bf16", conv_impl="ops")
        out_ops, launches["ops"] = run_path(
            "ops", lambda: syn_ops.restore_image(odd),
            ("conv3x3_mid", "conv3x3_tail_residual"))
        check_image("ops", out_ops, (321, 481, 3))
        t0 = time.perf_counter()
        for _ in range(5):
            syn_ops.restore_image(odd)
        torch.cuda.synchronize()
        report["ops"] = dict(ms_per_image=(time.perf_counter() - t0) / 5
                             * 1e3)
        log(f"  {report['ops']['ms_per_image']:.2f} ms per image (host "
            f"clock, copies to and from the card included)")
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
            # (64, 64) passes the fused-head gate (K3), (29, 35) fails it
            # (K2); the syn forwards are the fp32 path's one run
            xs = {hw: rng.random((1, *hw, 3), dtype=np.float32)
                  for hw in ((64, 64), (29, 35))}

            def card_forwards():
                with torch.inference_mode():
                    return {hw: gpu(torch.from_numpy(x).cuda())
                            for hw, x in xs.items()}
            if task == "denoising-syn":
                outs, launches["fp32"] = run_path(
                    "fp32", card_forwards,
                    ("dncnn_head_fused", "dncnn_fused", "conv3x3_mid",
                     "conv3x3_tail_residual"))
            else:
                outs = card_forwards()
            for hw, x in xs.items():
                with torch.inference_mode():
                    mu_c, s_c = cpu(torch.from_numpy(x))
                mu_g, s_g = outs[hw]
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

    if "probe" in phases:
        phase_probe(report, launches)

    if "sisr_fwd" in phases:
        log("[sisr_fwd] VIRNetSR x4 demo weights, card vs CPU, fp32")
        phase_sisr_fwd(report)

    if "train_fp32" in phases:
        log("[train_fp32] one SISR training step at 2x96^2, card vs CPU")
        phase_train_fp32(report)

    if "train_sisr" in phases:
        phase_train_sisr(report, launches)

    if "train_denoise_fp32" in phases:
        log("[train_denoise_fp32] one denoising training step at 2x64^2, "
            "syn and real, card vs CPU")
        phase_train_denoise_fp32(report)

    if "train_denoise" in phases:
        phase_train_denoise(report, launches)

    report["launches"] = launches
    report["total_s"] = time.perf_counter() - t_all
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))

    # one row per kernel: its times and error (K1-K4 at the flagship
    # checkpoint in bf16, fp32 K3 in fp32, K5-K7 at the training shape in
    # f32), and its
    # launches in the one run of the path it serves
    rows = []
    for name, meta in KERNELS.items():
        key, tag = ROW_TAG[name]
        m = report.get("kernels", {}).get(key, {}).get(tag, {})
        counter = meta.get("counter", name)
        rows.append(dict(
            name=name, route="cuda", source=meta["source"],
            uses=meta.get("uses"), replaces=meta["replaces"],
            launches=launches.get(meta["path"], {}).get(counter, 0),
            launches_path=meta["path"],
            launches_by_path={p: c.get(counter, 0)
                              for p, c in launches.items()},
            max_abs_err=m.get("max_abs_err"), ms=m.get("ms"),
            plain_ms=m.get("plain_ms"), bound_ms=m.get("bound_ms"),
            bound_by=m.get("bound_by"), library_ms=m.get("library_ms"),
            timing=m.get("timing"), warm_ms=m.get("warm_ms"),
            library=m.get("library")))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
