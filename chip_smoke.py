#!/usr/bin/env python3
"""Smoke run of the virnet_tpu_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--phases build,kernels,resblock,blur,fp32,psnr,
                           probe,sisr_fwd,serve_sisr,train_fp32,
                           train_sisr,train_pipeline,train_denoise_fp32,
                           train_denoise,eval_tables,runtime,int8,grids,
                           prepare]
                          [--report PATH] [--parent DIR]

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
             beside its library route on the shifted slab view
  resblock   (also run by kernels) K11, RNet's body conv with the block's
             passes inside, against its plain version in both modes on a
             block of default-init weights at the flagship batch's three
             scales (32x256^2x96, 32x128^2x192, 32x64^2x288) and the real
             preset's 160 and 224 (4x128^2, 4x64^2); the block (two K11
             launches) against the same weights on today's route (cuDNN
             and PyTorch's bias, LeakyReLU and residual passes); each
             launch and each block timed cold beside its bound, its plain
             version and the library route (cuDNN's conv with its bias
             pass for a launch; the whole block for a block); fails where
             a flagship scale's block is not faster than today's
  blur       builds csrc/blur.cu alone (without the phase build; ptxas's
             registers and spills of each K7 build printed) and holds the
             blur kernels (K5 forward, K6 dX, K7 dW) against their plain
             versions in f32 at the training shape (16x192^2x3, k=21; also
             through the public op in both pad modes with autograd), one
             eval shape (1x512^2x3) and one awkward shape (2x13x17x2, k=5),
             K6 and K7 run twice for equal bits; at the training shape K5,
             K6 and K7 also through a second build of blur.cu whose images
             take the any-C build (same bits required; its time is
             any_c_ms) and, with --parent DIR, each beside the same
             function of DIR's csrc/blur.cu (a checkout of another tree,
             built beside this one) in turns: parent, this, this, parent
  fp32       card forward vs the same model on the CPU (plain versions),
             both presets, one shape through K3 and one through K2 (the
             level chain in fp32); launches of the syn forwards
  psnr       denoising a seeded smooth image with sigma=25/255 noise
             (denoising-syn, bf16)
  probe      cli.bench_fused_head.run at the flagship shape, full width:
             unfused, halo (K3 + K4) and slabzero (K8 + K4) on 8-, 16- and
             32-row slabs; launches of one apply of each, ms per apply, MP/s
             and halo - slabzero (K8 runs K3's kernel on slabs, so at 32
             rows this is what K3's row halo costs an apply)
  sisr_fwd   VIRNetSR with the x4 demo weights on a 4x48x48 LR batch, card
             (K2 + K4) vs CPU in fp32
  serve_sisr Restorer('sisr', sf=4) with the x4 demo weights: restore_image
             of a seeded 125x171 LR image (odd sizes through K2 and KNet)
             to 500x684, fp32 card vs CPU (mu atol 1e-4); launches of one
             image in fp32 and in bf16, exactly K2 (snet_conv1 + K1 x3 +
             snet_last) once and K4 once; in each compute K2, each of its
             K1 levels and K4 against their plain versions on the
             arguments one image hands them (recorded on another call);
             ms per image in bf16 and fp32 (time_image), output MP/s
  train_fp32 one SISR training step at 2x96^2 (full width) in fp32 with
             injected noise, card vs CPU: loss, ELBO terms, gradient norms
  train_sisr the SISR trainer built from configs/sisr_x4.json (full width,
             batch 16, 192^2, bf16 autocast) for 30 steps on seeded smooth
             HR batches: launches of one step (K5 x2, K6, K7), each
             kernel held against its plain version on the first step's own
             arguments (the blur phase's bars scaled by the input's
             range), ms per step, peak memory, a device-time breakdown of
             one step, and the ELBO on a fixed batch with fixed noise
             before and after
  train_pipeline  the input pipeline under the trainers, full width (and
             the host cost of one tiny launch, beside the one taken
             before any phase: an earlier profiler session raises it):
             configs/sisr_x4.json with add_jpeg + jpeg_in_graph for 30
             steps of SISRTrainer.run_step_device on 64 seeded uint8
             records of 256^2 (DeviceDataset): exactly K5 x2, K6, K7 a
             step, each held against its plain version on the first
             step's own arguments (the blur phase's bars scaled by the
             input's range), the ELBO on a fixed batch with fixed draws
             before and after, ms per step beside train_sisr's host-fed
             step and, in turns, beside host-fed steps and device-data
             steps with the JPEG branch off, jpeg_degrade
             on that step's 16x48^2 LR batch on the card with TF32 off
             and on (the same bits) and on the CPU (no difference outside
             a tie); host JPEG (HostSISRSampler,
             libjpeg) for 10 steps with prefetch=2 and 10 with 0, ms per
             step and the prefetcher's stats (K5, K6, K7 once a step);
             configs/denoising_real.json on a pack file of 64 seeded
             pairs of 256^2, 10 steps through PackDBSampler and the
             prefetcher and 10 through DeviceDataset.from_packdb, twice in
             turns, ms per step and the records' bytes on the card (no
             kernel of ours)
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
  eval_tables  the benchmark harnesses on seeded synthetic data and the
             demo weights (no data set is in the repo).  Table 4: a SIDD
             validation pair in the real layout (40 x 32 blocks of 256^2
             uint8) through cli.eval_sidd in bf16 with --batch 16 and
             --device_metrics, the x8 ensemble one forward of 128 blocks:
             megatime, peak memory, exactly one K3 and one K4 launch per
             forward, device against host PSNR/SSIM per block (bars 2e-3
             dB, 1e-4); fp32 on the first 64 blocks (megatime, peak
             memory); in each compute K3 (in fp32 each K1 level of its
             chain, and sigma against the float64 function) and K4
             against their plain versions on the arguments one forward
             of 128 blocks hands them; tta_x8 of 4 blocks
             against Restorer.restore_image_tta in fp32 (atol 1e-4).
             Tables 1/2 (8 images at 321x481 and 481x321, niid; each case
             must beat its noisy input's PSNR) and 5 (4 HR 500x684, x4,
             the 7 kernels, LPIPS with seeded random weights) through K2 +
             K4 in bf16 and fp32, seconds per case and per kernel; K2, its
             K1 levels and K4 against their plain versions on the first
             call of each shape the harness made (batches of 4 in both
             orientations; the LR batch 4x125x171); LPIPS card against CPU
             (rtol 1e-4); the host SSIM against the cv2 version it
             replaced (ms and difference, bar 1e-12); the eval command
             lines' parameter and FLOPs lines
  runtime    the multi-device and runtime modules at full width with the
             demo weights.  Row-sharded restores (eval/spatial.py) on
             mesh = [cuda:0] x 4: denoising syn and real on a seeded
             smooth 2048x1536 image (halo 160) and SISR x4 384x512 ->
             1536x2048 (halo 64, noise_avg), fp32 against the raw
             whole-image forward on the card (max abs 1e-5), exactly one
             K2 chain and one K4 per run, each held against its plain
             version on the run's own arguments, peak memory and ms of
             both routes; bf16 and int8 Restorers, whose strips run fp32
             (as the JAX engine's): the fp32 route's launches and the fp32
             Restorer's sharded bits, ms; Restorer(bf16, mesh=[cuda:0] x
             2) on 33 x 256^2
             against no mesh, K3 + K4 once per chunk, held on a chunk's
             arguments; the SISR step of configs/sisr_x4.json, world 1 on
             NCCL against the plain trainer (10 steps, the same bits; K5
             x2, K6, K7 held on a step's arguments; ms in turns) and two
             ranks spawned on the card over gloo (fp32, 8 rows each, 5
             steps) against one process (loss rtol 1e-5, parameters atol
             1e-5); remat on against off for the syn and SISR steps (the
             same bits in the loss and every gradient; peak memory and ms
             in turns); two runs of each step with cuDNN deterministic and
             with TF32 off alone (differing tensors counted; ms in turns);
             cli/resilience_proof on configs/denoising_syn.json (2 x 20
             steps, killed at epoch 2 step 10: bitwise); cli/endurance
             --minutes 0.5 --mode real through the pack and with
             --device_data
  int8       int8 (W8A8) serving with the demo weights: Restorer(compute=
             'int8') on the flagship 32x256^2 batch of denoising-syn and
             denoising-real and on serve_sisr's 125x171 x4 image, exactly
             one K10 (absmax) and one K9 launch per gated convolution and
             nothing else of ours; K9 against its plain version (the
             float input quantized with the recorded scales, then the
             int8 product) on the arguments of every gated (Ci, Co, k)
             those forwards hand it (the dequantized output bit for bit,
             and the int32 sums bit for bit on small-range integers of the
             same shapes fed as float with scale 1), K10 against its plain
             version bit for bit on every gated input, each timed cold
             beside its bound (K9: int8 tensor-core peak and memory; K10:
             memory), its plain version and a library route (K9: the same
             quantize then torch._int_mm behind an im2col; K10:
             torch.linalg.vector_norm(x, inf)); ms per batch of int8 and
             bf16 in turns (bf16, int8, int8, bf16), the device time of
             one int8 forward by kernel, no quantize op (abs, max, divide,
             round, clamp) over a gated conv's input in any int8 forward
             (syn, real, SISR), and the quantize
             + product alone (the forward's conv_w8a8 calls replayed);
             the sisr image's profile (aten::copy_: the NCHW inputs that
             to_nhwc copies); PSNR of int8 and of bf16 against fp32 (and
             each against the clean image) on the psnr phase's image; a
             trainer checkpoint through cli/export_torch, load_pth and a
             Restorer, the same bits as the demo weights
  grids      the trainers' per-epoch validation with the TensorBoard image
             and kernel grids, full width: train_sisr.validate_epoch with
             the trainer of configs/sisr_x4.json on a SISRValSet of two
             seeded 128^2 HR images, and train_denoising_syn.validate_epoch
             with that of configs/denoising_syn.json on a DenoiseValSet of
             two seeded 128^2 images, into a recording writer (tensorboardX
             is absent here); exactly the JAX trainers' tags (four per SISR
             set: restored, GT, input, kernels est|gt; three for
             denoising), every array finite and in [0, 1], each kernel
             summing to 1 within 1e-5, the restored grids and kernel images
             within atol 1e-4 of the same weights on the CPU and the GT and
             input grids the same bits; ms of the block and of the grid
             calls alone; no kernel of the package launches (the
             trainers' conv_impl='torch' model on the im2col route)
  prepare    offline data preparation on this machine's host: three
             seeded 600x600 PNGs through crop_hr_patches (12 crops of
             512^2), isp_process_patches in a spawned pool of 2,
             make_kernel_bank, synth_camera_pairs and verify_corpus, twice:
             the same bytes (a .mat's past its header, which holds the
             creation time) and results, and the layouts of
             tests/test_prepare.py and tests/test_isp.py;
             write_noise_benchmark_h5 raises an ImportError naming h5py
             where h5py is absent, else its files read back through
             H5BenchmarkReader; seconds

Every main-path phase (fp32, probe, serve_sisr, train_sisr,
train_pipeline, eval_tables, runtime, int8, grids)
zeroes the launch counters, drives its path once and reads them; it fails
if a kernel of its path did not launch (grids: if any launched).  The line before the card's line is one JSON
object with the kernels' numbers: times and errors from the syn weights
in bf16 (K1-K4, K8 on 32-row slabs) or at the training shape in f32
(K5-K7) or at RNet's 96-wide body conv of the int8 flagship batch (K9,
K10),
and each kernel's launches in the one run of the path it serves
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
import contextlib
import copy
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ALL_PHASES = ("build", "kernels", "resblock", "blur", "fp32", "psnr", "probe",
              "sisr_fwd", "serve_sisr", "train_fp32", "train_sisr",
              "train_pipeline", "train_denoise_fp32", "train_denoise",
              "eval_tables", "runtime", "int8", "grids", "prepare")
SYN_CKPT = ROOT / "model_zoo" / "virnet_denoising_syn_demo.pth"
REAL_CKPT = ROOT / "model_zoo" / "virnet_denoising_real_demo.pth"
SISR_CKPT = ROOT / "model_zoo" / "virnet_sisr_x4_demo.pth"
SISR_CONFIG = ROOT / "configs" / "sisr_x4.json"
DENOISE_CONFIGS = {"syn": ROOT / "configs" / "denoising_syn.json",
                   "real": ROOT / "configs" / "denoising_real.json"}

# card peaks (NVIDIA data sheets, dense): bf16 tensor-core FLOP/s, fp32
# CUDA-core FLOP/s (the kernels run f32 on CUDA cores with TF32 off), int8
# tensor-core OP/s, and memory bytes/s
PEAKS = {
    "H100 SXM": dict(bf16=989e12, fp32=67e12, int8=1979e12, bytes=3.35e12),
    "H100 PCIe": dict(bf16=756e12, fp32=51e12, int8=1513e12, bytes=2.0e12),
    "H100 NVL": dict(bf16=835e12, fp32=60e12, int8=1671e12, bytes=3.9e12),
}

KERNELS = {
    "conv3x3_mid": dict(
        path="serve_sisr", source="virnet_tpu_torch/csrc/conv3x3_mid.cu",
        replaces="virnet_tpu/ops/pallas_conv.py:627 (conv3x3_mid_pair), "
                 ":297 (conv3x3_mid_stack_pair)"),
    "dncnn_fused": dict(
        path="serve_sisr", source="virnet_tpu_torch/csrc/snet_levels.cu",
        uses="virnet_tpu_torch/csrc/conv3x3_mid.cu (K1, the mid levels)",
        replaces="virnet_tpu/ops/pallas_conv.py:474 (dncnn_pair_fused)"),
    "dncnn_head_fused": dict(
        path="runtime_dp_restore",
        source="virnet_tpu_torch/csrc/dncnn_head.cu",
        replaces="virnet_tpu/ops/pallas_conv.py:1289 (dncnn_head_fused "
                 "halo :1512, carry :1459)"),
    "conv3x3_tail_residual": dict(
        path="runtime_dp_restore",
        source="virnet_tpu_torch/csrc/tail_residual.cu",
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
    "conv_w8a8": dict(
        path="int8", source="virnet_tpu_torch/csrc/conv_w8a8.cu",
        replaces="not a Pallas kernel: virnet_tpu/ops/qconv.py:44 "
                 "(conv_w8a8), whose activation quantize and int8 product "
                 "XLA computes"),
    "absmax_nhwc": dict(
        path="int8", source="virnet_tpu_torch/csrc/conv_w8a8.cu",
        replaces="not a Pallas kernel: virnet_tpu/ops/qconv.py:38 "
                 "(quantize_symmetric's absmax over (N, H, W), an XLA "
                 "reduction)"),
    "resblock_conv": dict(
        path="runtime_dp_restore",
        source="virnet_tpu_torch/csrc/resblock_conv.cu",
        replaces="not a Pallas kernel: RNet's body convolutions "
                 "(virnet_tpu/models/common.py:conv), into which XLA fuses "
                 "the bias, LeakyReLU and residual passes"),
}
# the measurement a kernel's row of the last-but-two line is taken from:
# (results key, tag)
ROW_TAG = {name: (name, "train f32" if name.startswith("blur")
                  else "syn bf16") for name in KERNELS}
ROW_TAG["dncnn_head_fused_fp32"] = ("dncnn_head_fused", "syn fp32")
# K9's and K10's rows: RNet's 96-wide 3x3 body conv of the int8 flagship
# batch, the shape that most of their launches take
ROW_TAG["conv_w8a8"] = ("conv_w8a8", "syn 32x256x256x96 k3 96")
ROW_TAG["absmax_nhwc"] = ("absmax_nhwc", "syn 32x256x256x96")
# K11's row: a whole block (two launches) at the flagship batch's scale 0
ROW_TAG["resblock_conv"] = ("resblock_conv", "syn 32x256x256x96 block")


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


def launch_us(n: int = 2000) -> float:
    """Host microseconds per launch of a tiny in-place add, back to back
    (the eager steps of the trainers are bound by this cost)."""
    x = torch.zeros(1024, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


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
    report.setdefault("kernels", {}).update(results)


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

        # K1 at one mid conv of K2's chain at 321x481
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



# K11's shapes: RNet's body convs at the flagship batch's three scales and
# the real preset's 160 and 224 wide (the `real` phase's batch of 4)
RESBLOCK_SHAPES = (("syn", 32, 256, 96), ("syn", 32, 128, 192),
                   ("syn", 32, 64, 288), ("real", 4, 128, 160),
                   ("real", 4, 64, 224))


@contextlib.contextmanager
def plain_on_card():
    """The plain versions' float32 convolutions on the card in full
    float32 (TF32 off) and off cuDNN, whose heuristics pick FFT for RNet's
    shapes with TF32 off (precision.py): PyTorch's im2col route."""
    from virnet_tpu_torch.precision import parity_mode

    with parity_mode(), torch.backends.cudnn.flags(enabled=False):
        yield


def phase_resblock(report, peaks):
    """K11 at RNet's body widths: each mode against its plain version, the
    block (two launches) against the same weights on today's route (cuDNN
    and PyTorch's passes), and the times of each launch and each block,
    cold, beside their bounds.  Fails where a flagship scale's block is
    not faster than today's."""
    import torch.nn.functional as F

    from virnet_tpu_torch.models.attresunet import AttResBlock
    from virnet_tpu_torch.models.common import hwio, to_nchw
    from virnet_tpu_torch.ops import fused_conv as fc
    from virnet_tpu_torch.ops import resblock

    results = report.setdefault("kernels", {}).setdefault("resblock_conv",
                                                          {})
    bf = torch.bfloat16
    for label, n, size, nf in RESBLOCK_SHAPES:
        shape = f"{label} {n}x{size}x{size}x{nf}"
        log(f"[resblock] K11 at {shape} (plan {resblock.plan(nf, nf)})")
        torch.manual_seed(nf)
        blk = AttResBlock(nf).to("cuda", bf).eval()
        blk.kernels = True
        x = torch.randn(n, size, size, nf, device="cuda").to(bf)
        xc = to_nchw(x)
        c1, c2 = blk.conv1, blk.conv2
        w1, w2 = hwio(c1.weight), hwio(c2.weight)
        w1k, w2k = resblock.kernel_weights(w1), resblock.kernel_weights(w2)
        npx = n * size * size
        wbytes = (w1.numel() + nf) * 2
        with torch.inference_mode():
            fc.reset_launches()
            f = resblock.resblock_conv(x, w1k, c1.bias, "first")
            out = resblock.resblock_conv(f, w2k, c2.bias, "second",
                                         residual=x)
            torch.cuda.synchronize()
            if fc.LAUNCHES["resblock_conv"] != 2:
                raise AssertionError("resblock: a block is not two K11 "
                                     "launches")
            with plain_on_card():
                f_ref = resblock.resblock_conv_plain(x, w1, c1.bias, "first")
                o_ref = resblock.resblock_conv_plain(f, w2, c2.bias,
                                                     "second", residual=x)
            errs = dict(
                first=check_close(f"resblock_conv {shape} first", f, f_ref,
                                  bf),
                second=check_close(f"resblock_conv {shape} second", out,
                                   o_ref, bf))
            del f_ref, o_ref
            if not blk.takes_kernel(xc, None) or not torch.equal(
                    blk(xc, None), to_nchw(out)):
                raise AssertionError("resblock: the block's route is not "
                                     "its two K11 launches")
            blk.kernels = False
            today = blk(xc, None)
            errs["block_vs_today"] = check_close(
                f"resblock block {shape} vs today's route", to_nchw(out),
                today, bf)
            del today

            def today_fn():
                return blk(xc, None)

            def k11_block():
                return blk.forward_kernel(xc)

            def plain_block():
                with plain_on_card():
                    g = resblock.resblock_conv_plain(x, w1, c1.bias, "first")
                    return resblock.resblock_conv_plain(
                        g, w2, c2.bias, "second", residual=x)

            flops = 2 * 9 * nf * nf * npx
            rows = {}
            for mode, args, fn_lib, extra in (
                    ("first", (x, w1k, c1.bias, "first"),
                     lambda: F.leaky_relu(F.conv2d(
                         F.leaky_relu(xc, 0.2), c1.weight, c1.bias,
                         padding=1), 0.2), 0),
                    ("second", (f, w2k, c2.bias, "second", x),
                     lambda: F.conv2d(to_nchw(f), c2.weight, c2.bias,
                                      padding=1) + xc, 1)):
                nbytes = npx * nf * 2 * (2 + extra) + wbytes
                b_ms, b_by = bound_ms(flops, nbytes, peaks["bf16"], peaks)
                ms = time_cold_ms(lambda a=args: resblock.resblock_conv(*a), 5)
                lib_ms = time_cold_ms(fn_lib, 5)
                check_bound(f"resblock_conv {shape} {mode}", "the kernel", ms,
                            b_ms)
                rows[mode] = dict(
                    max_abs_err=errs[mode], ms=ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms, flops=flops,
                    bytes=nbytes, timing="cold L2", warm_ms=time_ms(
                        lambda a=args: resblock.resblock_conv(*a), 5),
                    library="cuDNN's conv with PyTorch's own passes of this "
                            "launch's function")
                log(f"  {mode}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                    f"TFLOP/s), library {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}), warm {rows[mode]['warm_ms']:.4f} ms")
            k_ms = time_cold_ms(k11_block, 5)
            lib_ms = time_cold_ms(today_fn, 5)
            plain_ms = time_cold_ms(plain_block, 2)
            b_ms = rows["first"]["bound_ms"] + rows["second"]["bound_ms"]
            rows["block"] = dict(
                max_abs_err=errs["block_vs_today"], ms=k_ms, bound_ms=b_ms,
                bound_by="operations", library_ms=lib_ms, plain_ms=plain_ms,
                timing="cold L2", warm_ms=time_ms(k11_block, 5),
                library_warm_ms=time_ms(today_fn, 5),
                library="today's block: cuDNN's two convs and PyTorch's "
                        "bias, LeakyReLU and residual passes")
            for mode in ("first", "second"):
                rows[mode]["plain_ms"] = plain_ms / 2
            log(f"  block: K11 x2 {k_ms:.4f} ms against today's route "
                f"{lib_ms:.4f} ms ({lib_ms / k_ms:.2f}x), bound {b_ms:.4f} "
                f"ms ({100 * b_ms / k_ms:.1f}% of it), plain {plain_ms:.4f} "
                f"ms; warm {rows['block']['warm_ms']:.4f} against "
                f"{rows['block']['library_warm_ms']:.4f} ms")
            for key, row in rows.items():
                results[f"{shape} {key}"] = row
            if label == "syn" and k_ms >= lib_ms:
                raise AssertionError(
                    f"resblock: K11's block at {shape} ({k_ms:.4f} ms) is "
                    f"not faster than today's route ({lib_ms:.4f} ms)")
        del blk, x, xc, f, out
    # the wrapper's host cost a call: back-to-back launches on a tiny input,
    # where the card waits on the host
    x = torch.randn(1, 8, 8, 96, device="cuda").to(bf)
    wk = resblock.kernel_weights(torch.randn(3, 3, 96, 96, device="cuda").to(
        bf))
    b = torch.zeros(96, device="cuda", dtype=bf)
    with torch.inference_mode():
        for _ in range(20):
            resblock.resblock_conv(x, wk, b, "second", residual=x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            resblock.resblock_conv(x, wk, b, "second", residual=x)
        host_us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    results["host_us_per_call"] = host_us
    log(f"  host cost of one K11 call (1x8x8x96, back to back): "
        f"{host_us:.1f} us")


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


def blur_copy_build(name, src, include):
    """Start nvcc on `src`, the text of a blur.cu, into its own library in
    the build directory (headers from `include`); returns the process and
    a function that waits for it and gives the library's four blur
    entries, bound as ops/fused_conv binds them."""
    import ctypes

    from virnet_tpu_torch.ops import _build
    from virnet_tpu_torch.ops import fused_conv as fc

    d = _build.build_dir() / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "blur.cu").write_text(src)
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(include),
         "-o", str(d / "libblur.so"), str(d / "blur.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def fns():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/blur.cu:\n{out}")
        lib = ctypes.CDLL(str(d / "libblur.so"))
        got = {}
        for sym in ("vt_blur_valid", "vt_blur_dx", "vt_blur_dw",
                    "vt_blur_dw_scratch_elems"):
            f = getattr(lib, sym)
            f.argtypes = fc._SIGNATURES[sym][1]
            f.restype = (ctypes.c_longlong if sym.endswith("_scratch_elems")
                         else ctypes.c_int)
            got[sym] = f
        return got
    return proc, fns


def any_c_blur_build():
    """A copy of csrc/blur.cu whose images (C = 3) take the any-C builds
    of K5/K6 and K7 instead of the C = 3 builds."""
    from virnet_tpu_torch.ops import _build

    src = (_build.CSRC / "blur.cu").read_text()
    pat = "constexpr bool IMAGE_BUILDS = true;"
    if src.count(pat) != 1:
        raise RuntimeError(f"blur.cu: {pat!r} occurs {src.count(pat)} "
                           f"times, expected once")
    return blur_copy_build(
        "blur_any_c", src.replace(pat, pat.replace("true", "false")),
        _build.CSRC)


@contextlib.contextmanager
def blur_fns(fns):
    """The blur wrappers of ops/blur.py on another library's entries."""
    from virnet_tpu_torch.ops import fused_conv as fc

    saved = {sym: fc._fn(sym) for sym in fns}
    fc._FNS.update(fns)
    try:
        yield
    finally:
        fc._FNS.update(saved)


def ptxas_k7(log_text) -> dict:
    """Registers and spill bytes of each K7 build in a ptxas -v log:
    {"blur_dw_kernel<K, C3>": dict(registers=, spill_stores=,
    spill_loads=)}."""
    import re

    out: dict = {}
    entry = None
    for line in log_text.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            k = re.search(r"blur_dw_kernelILi(\d+)ELi(\d+)E", m.group(1))
            entry = f"blur_dw_kernel<{k.group(1)}, {k.group(2)}>" if k \
                else None
            if entry:
                out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def sass_mix(lib_path, pattern) -> dict:
    """Static opcode counts ({"FFMA": n, "LDS": n, ...}, modifiers cut)
    of each function of the library whose mangled name matches `pattern`,
    from the toolkit's cuobjdump -sass ({} where there is none)."""
    import collections
    import re

    from virnet_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300).stdout
    mixes: dict = {}
    cur = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if re.search(pattern, m.group(1)) else None
            if cur:
                mixes[cur] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if cur and m:
            mixes[cur][m.group(1)] += 1
    return {k: dict(v) for k, v in mixes.items()}


def short_kernel(full: str) -> str:
    """`blur_dw_kernel<21, 3>` of a profiler's `void (anonymous
    namespace)::blur_dw_kernel<21, 3>(float const*, ...)`."""
    import re

    m = re.search(r"::(\w+(?:<[^<>]*>)?)\(", full)
    return m.group(1) if m else full[:40]


def phase_blur(report, peaks, parent=None):
    """Builds csrc/blur.cu (alone where the phase build did not run), its
    any-C copy and, with `parent`, the parent tree's blur.cu, the three
    nvcc at once; then the checks and times of blur_kernels."""
    from virnet_tpu_torch.ops import _build

    procs = []
    proc, any_c = any_c_blur_build()
    procs.append(proc)
    other = None
    if parent is not None:
        csrc = Path(parent) / "virnet_tpu_torch" / "csrc"
        proc, other = blur_copy_build("blur_parent",
                                      (csrc / "blur.cu").read_text(), csrc)
        procs.append(proc)
    try:
        t0 = time.perf_counter()
        _build.load("blur")
        secs = time.perf_counter() - t0
        log_path = _build._lib_path("blur").with_suffix(".log")
        k7 = ptxas_k7(log_path.read_text()) if log_path.exists() else {}
        log(f"[blur] csrc/blur.cu ready in {secs:.1f} s; K7 builds: "
            + ", ".join(f"{k} {v.get('registers')} registers, spills "
                        f"{v.get('spill_stores')}/{v.get('spill_loads')} B"
                        for k, v in sorted(k7.items())))
        # K7's image build: FFMAs against shared loads (LDS) and the rest
        sass = sass_mix(_build._lib_path("blur"),
                        r"blur_dw_kernelILi21ELi3E")
        for fn, mix in sass.items():
            log(f"  SASS of blur_dw_kernel<21, 3>: {sum(mix.values())} "
                f"instructions, " + ", ".join(
                    f"{op} {mix.get(op, 0)}" for op in
                    ("FFMA", "LDS", "LDGSTS", "BAR", "SHFL", "STG")))
        report["blur_build"] = dict(seconds=secs, ptxas_k7=k7,
                                    sass_k7=sass)
        blur_kernels(report, peaks, any_c, other)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def blur_kernels(report, peaks, any_c, parent=None):
    """K5-K7 against their plain versions on the card in f32.  Bounds:
    forward and dX atol 2e-5 on inputs in [0, 1) with taps summing to 1
    (the same k*k products summed in another order), dW 1e-5 of max|dW| (a
    sum of H*W*C products per tap).  K6 and K7 run twice: equal bits.  At
    the training shape K5-K7 are also timed through the any-C build
    (`any_c_ms`), K5/K6 with the same bits as the C = 3 build, and,
    where `parent` gives another build's entries, in turns with them
    (`turns`: parent, this, this, parent; the parent's K7 held to the same
    bar)."""
    import torch.nn.functional as F

    from virnet_tpu_torch.ops import blur
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
        train = (xp, g, kern)
        # the any-C build on the same inputs: the same sums in the same
        # order, so the same bits; what the C = 3 builds' constant shared
        # rows are worth
        with blur_fns(any_c()):
            if not (torch.equal(blur.blur_valid(xp, kern), out)
                    and torch.equal(blur.blur_dx(g, kern), dxp)):
                raise AssertionError("the any-C build of K5/K6 gave other "
                                     "bits than the C = 3 build")
            # K7's partials follow its grid, which follows each build's
            # occupancy: the bar, not the bits
            check_abs("blur_dw any-C build", blur.blur_dw(xp, g), dw_ref,
                      1e-5 * float(dw_ref.abs().max()))
            for name in ("blur_valid", "blur_dx", "blur_dw"):
                ms = time_ms(kerns[name], 20)
                results[name][tag]["any_c_ms"] = ms
                log(f"  {name}: any-C build {ms:.4f} ms (C = 3 build "
                    f"{results[name][tag]['ms']:.4f} ms)")
        if parent is not None:
            fns = parent()
            with blur_fns(fns):
                check_abs("parent's blur_dw", blur.blur_dw(xp, g), dw_ref,
                          1e-5 * float(dw_ref.abs().max()))
            for name in ("blur_valid", "blur_dx", "blur_dw"):
                turns = []
                for who in ("parent", "this", "this", "parent"):
                    with blur_fns(fns) if who == "parent" else \
                            contextlib.nullcontext():
                        turns.append((who, time_ms(kerns[name], 20)))
                results[name][tag]["turns"] = turns
                log(f"  {name} in turns: " + ", ".join(
                    f"{who} {ms:.4f}" for who, ms in turns) + " ms")

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

    # at the training shape: each kernel's device time a call
    # (torch.profiler) beside the host time a call of its wrapper takes to
    # enqueue (50 calls, well inside the launch queue, then one sync);
    # last, as a profiler session leaves later launches dearer (PR 14)
    xp, g, kern = train
    for name, fn in (("blur_valid", lambda: blur.blur_valid(xp, kern)),
                     ("blur_dx", lambda: blur.blur_dx(g, kern)),
                     ("blur_dw", lambda: blur.blur_dw(xp, g))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        dev = {k: v[0] for k, v in profile_calls(fn, 20)["kernels"].items()}
        results[name]["train f32"].update(device_ms=dev, host_us=host_us)
        log(f"  {name} at the training shape: host {host_us:.1f} us a call "
            f"to enqueue; device " + (", ".join(
                f"{short_kernel(k)} {ms * 1e3:.2f} us"
                for k, ms in dev.items()) or "not measured (the profiler "
                                             "saw no kernels)"))


# kernel-name keys of each group, the first match wins
TRAIN_GROUPS = (
    ("K5 blur_valid", ("blur_valid_kernel",)),
    ("K6 blur_dx", ("blur_dx_kernel",)),
    ("K7 blur_dw", ("blur_dw_kernel", "blur_dw_reduce")),
    ("optimizer", ("multi_tensor", "adam", "foreach", "lpnorm")),
    ("cuDNN layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("cuDNN backward", ("dgrad", "wgrad", "bwd", "backward", "bprop")),
    ("cuDNN forward", ("cudnn", "xmma", "implicit", "conv", "fprop",
                       "cutlass")),
    ("matmul", ("gemm", "gemv", "cublas")))


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


def check_launches(name, counts, want):
    """Fail unless the launches ``counts`` are exactly ``want`` (kernels not
    named there: none)."""
    extra = {k: n for k, n in counts.items() if n != want.get(k, 0)}
    if extra:
        raise AssertionError(f"{name}: launched {extra}, expected exactly "
                             f"{want}")


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
    want = {"unfused": {}, "halo": dict(SERVE_PATH)}
    for v in variants[2:]:
        want[v] = {"dncnn_head_slabzero": 1, "conv3x3_tail_residual": 1,
                   "resblock_conv": SERVE_PATH["resblock_conv"]}
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


SISR_PATH = {"dncnn_fused": 1, "conv3x3_mid": 3, "conv3x3_tail_residual": 1}
# bf16 adds K11 twice for each of RNet's 4 unconditioned up-path blocks
SISR_BF16_PATH = dict(SISR_PATH, resblock_conv=8)


@contextlib.contextmanager
def recording(module, name, calls, per_shape=False):
    """Inside the block ``module.<name>`` appends the arguments of each
    call to ``calls`` and computes as before; with ``per_shape`` only the
    first call of each input shape, its tensors copied (a harness drives
    many forwards and may reuse its buffers)."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        if not per_shape:
            calls.append((args, kwargs))
        elif all(a[0].shape != args[0].shape for a, _ in calls):
            calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                                for a in args), kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, fn)


def check_path_kernels(key, restorer, im):
    """K2, each of its K1 levels and K4 against their plain versions on the
    card, on the arguments that one ``restorer.restore_image(im)`` hands
    them (recorded on a call of its own, after the counted one), with
    check_close's bounds in the compute dtype.  Returns the max diffs."""
    from virnet_tpu_torch.models import attresunet
    from virnet_tpu_torch.ops import fused_conv as fc

    snet, tail = [], []
    with recording(fc, "dncnn_fused", snet), \
            recording(attresunet, "conv3x3_tail_residual", tail):
        restorer.restore_image(im)
    if len(snet) != 1 or len(tail) != 1:
        raise AssertionError(f"{key}: one image called K2 {len(snet)} and "
                             f"K4 {len(tail)} times, expected once each")
    return check_k2_calls(key, snet, tail)


def shape_of(t) -> str:
    return "x".join(map(str, t.shape))


def check_levels(key, x, w1, b1, wms, bms, slope, errs):
    """Each K1 level of an SNet chain against its plain version, on the
    levels the plain chain computes from ``x`` (into ``errs``)."""
    from virnet_tpu_torch.ops import fused_conv as fc

    y = fc.conv3x3_plain(x, w1, b1, slope)
    for i in range(wms.shape[0]):
        want = fc.conv3x3_mid_plain(y, wms[i], bms[i], slope)
        errs[f"conv3x3_mid {shape_of(y)} {i}"] = check_close(
            f"{key} conv3x3_mid level {i}, {shape_of(y)}",
            fc.conv3x3_mid(y, wms[i], bms[i], slope), want, x.dtype)
        y = want


def check_tail(key, calls, errs):
    """K4 against its plain version on each recorded call (into ``errs``)."""
    from virnet_tpu_torch.ops import fused_conv as fc

    for targs, tkw in calls:
        feats = targs[0]
        errs[f"conv3x3_tail_residual {shape_of(feats)}"] = check_close(
            f"{key} conv3x3_tail_residual {shape_of(feats)}",
            fc.conv3x3_tail_residual(*targs, **tkw),
            fc.conv3x3_tail_residual_plain(*targs, **tkw), feats.dtype)


def check_k2_calls(key, snet, tail):
    """K2, its K1 levels and K4 against their plain versions on the card,
    on each recorded call's arguments, with check_close's bounds in the
    compute dtype.  Returns the max diffs."""
    from virnet_tpu_torch.ops import fused_conv as fc

    errs = {}
    with torch.inference_mode():   # the wrappers are forward-only
        for args, kw in snet:
            x, w1, b1, wms, bms = args[:5]
            errs[f"dncnn_fused {shape_of(x)}"] = check_close(
                f"{key} dncnn_fused {shape_of(x)}",
                fc.dncnn_fused(*args, **kw),
                fc.dncnn_fused_plain(*args, **kw), x.dtype)
            check_levels(key, x, w1, b1, wms, bms, kw.get("slope", 0.25),
                         errs)
        check_tail(key, tail, errs)
    return errs


def phase_serve_sisr(report, launches, lr_hw=(125, 171), sf=4):
    """SISR serving through Restorer at full width (the x4 demo weights):
    one odd-size LR image, fp32 on the card against the CPU, the launches
    of one image in each compute (exactly SISR_PATH, in bf16 with K11 on
    the up path: SISR_BF16_PATH), the path's kernels
    against their plain versions on its own arguments, and ms per image
    (time_image)."""
    from virnet_tpu_torch.eval.engine import Restorer

    h, w = lr_hw
    out_hw = (h * sf, w * sf, 3)
    log(f"[serve_sisr] Restorer('sisr', sf={sf}) restore_image {h}x{w} -> "
        f"{out_hw[0]}x{out_hw[1]} (K2: snet_conv1, K1 x3, snet_last; K4)")
    lr = np.random.default_rng(4).random((h, w, 3), dtype=np.float32)
    res = {}
    for compute in ("fp32", "bf16"):
        sr = Restorer("sisr", ckpt_path=SISR_CKPT, sf=sf, compute=compute)
        key = "serve_sisr" if compute == "fp32" else "serve_sisr_bf16"
        path = SISR_PATH if compute == "fp32" else SISR_BF16_PATH
        out, launches[key] = run_path(key, lambda: sr.restore_image(lr),
                                      tuple(path))
        check_image(key, out, out_hw)
        check_launches(key, launches[key], path)
        res[f"{compute}_kernels_max_abs_err"] = check_path_kernels(key, sr,
                                                                   lr)
        if compute == "fp32":
            cpu = Restorer("sisr", ckpt_path=SISR_CKPT, sf=sf,
                           device="cpu").restore_image(lr)
            res["mu_abs"] = float(np.abs(out - cpu).max())
            log(f"  fp32 card vs CPU: mu max diff {res['mu_abs']:.3g} "
                f"(atol 1e-4)")
            if res["mu_abs"] > 1e-4:
                raise AssertionError("serve_sisr: fp32 card output disagrees "
                                     "with the CPU")
        t = time_image(sr, lr, reps=20)
        mp = out_hw[0] * out_hw[1] / t["median_ms"] / 1e3
        res[compute] = dict(ms_per_image=t["median_ms"], min_ms=t["min_ms"],
                            out_mp_per_s=mp)
        log(f"  {compute}: {t['median_ms']:.2f} ms per image, median of 20 "
            f"(least {t['min_ms']:.2f}; host clock, copies included), "
            f"{mp:.2f} output MP/s")
        del sr
    report["serve_sisr"] = res


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
    """Device time of two profiled training steps by TRAIN_GROUPS, from
    torch.profiler (CUPTI, profile_calls), the share of their wall time
    the device was idle (the profiler's own overhead counts as idle), and
    the idle share against ``ms``, the median of the unprofiled steps
    (None when the profiler saw no kernel)."""
    prof = profile_calls(step_fn, 2)
    wall_ms = prof["wall_ms"]
    kernels = {name: t for name, (t, _) in prof["kernels"].items()}
    if not kernels:
        log("  device time: not measured (the profiler saw no kernels)")
        report[key] = None
        return None
    by_group: dict = {}
    for name, t in kernels.items():
        low = name.lower()
        group = next((g for g, keys in TRAIN_GROUPS
                      if any(k in low for k in keys)),
                     "elementwise, copies, reductions (PyTorch)")
        by_group[group] = by_group.get(group, 0.0) + t
    busy = sum(kernels.values())
    log(f"  per step: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}")
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"  {g}: {t:.3f} ms ({t / busy:.1%} of device time)")
    for name, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {t:8.3f} ms  {name[:90]}")
    ops = prof["torch_ops"]
    for op, t, count in ops[:12]:
        log(f"    {t:8.3f} ms  {op} x{count} (torch op, own kernels)")
    report[key] = dict(wall_ms=wall_ms, busy_ms=busy, groups=by_group,
                       idle_share=1 - busy / wall_ms, kernels=kernels,
                       torch_ops=ops)
    # the profiler slows the host down, so the busy time of the two
    # profiled steps is held against the median of the unprofiled
    # steps: two different sets of steps.  A negative share says that
    # they do not belong together.
    idle = 1 - busy / ms
    log(f"  device busy {busy:.2f} ms (2 profiled steps) of "
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
    from virnet_tpu_torch.ops import blur
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

    calls = {k: [] for k in BLUR_STEP}
    fc.reset_launches()
    with recording(blur, "blur_valid", calls["blur_valid"]), \
            recording(blur, "blur_dx", calls["blur_dx"]), \
            recording(blur, "blur_dw", calls["blur_dw"]):
        out = trainer.run_step(batch(), 0)
    torch.cuda.synchronize()
    counts = dict(fc.LAUNCHES)
    launches["train_sisr"] = counts
    log(f"  launches in one step {counts}, copies {dict(fc.COPIES)}")
    if (counts["blur_valid"], counts["blur_dx"], counts["blur_dw"]) != (
            2, 1, 1):
        raise AssertionError("train_sisr: one step must launch blur_valid "
                             "twice and blur_dx, blur_dw once each")
    errs = hold_blur_calls(calls)

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
        launches=counts, copies=dict(fc.COPIES), idle_share=idle,
        kernels_max_abs_err=errs)
    if not (math.isfinite(after) and after < before):
        raise AssertionError("train_sisr: the ELBO on the fixed batch did "
                             "not go down")


PIPELINE_DIR = ROOT / "build" / "chip_smoke_pipeline"
BLUR_STEP = {"blur_valid": 2, "blur_dx": 1, "blur_dw": 1}
HOST_BLUR_STEP = {"blur_valid": 1, "blur_dx": 1, "blur_dw": 1}


def textured_records(rng, n, size) -> np.ndarray:
    """Seeded uint8 images: smooth_image plus N(0, 0.03) texture, so that
    JPEG has detail to quantize."""
    im = smooth_batch(rng, n, size)
    im = im + rng.normal(0, 0.03, im.shape).astype(np.float32)
    return np.round(np.clip(im, 0, 1) * 255).astype(np.uint8)


def blur_bar(name, args) -> float:
    """The blur phase's bars (forward and dX atol 2e-5 on inputs in
    [0, 1) with taps summing to 1) scaled by the range of this call's
    input times the largest kernel's tap sum; dW 1e-5 of max |dW|."""
    from virnet_tpu_torch.ops import blur

    if name == "blur_dw":
        with torch.no_grad():
            return 1e-5 * float(blur.blur_dw_plain(*args).abs().max())
    x, kern = args
    scale = float(x.abs().max()) * float(kern.abs().sum((1, 2)).max())
    return 2e-5 * max(scale, 1.0)


def hold_blur_calls(calls) -> dict:
    """K5, K6 and K7 against their plain versions on the card, on the
    arguments one training step handed them."""
    from virnet_tpu_torch.ops import blur

    errs = {}
    for name, recorded in calls.items():
        plain = torch.no_grad()(getattr(blur, f"{name}_plain"))
        for i, (args, kw) in enumerate(recorded):
            args = tuple(a.detach() for a in args)
            errs[f"{name} {i}"] = check_abs(
                f"{name} call {i} of the step, {shape_of(args[0])}",
                getattr(blur, name)(*args, **kw), plain(*args, **kw),
                blur_bar(name, args))
    return errs


def check_step_launches(what, counts, per_step, steps):
    want = {k: v * steps for k, v in per_step.items()}
    extra = {k: n for k, n in counts.items() if n != want.get(k, 0)}
    if extra:
        raise AssertionError(f"{what}: {steps} steps launched {extra}, "
                             f"expected {per_step} per step")


def epoch_ms(trainer, steps, run_epoch):
    """Wall ms per step of one epoch of ``steps`` steps (``run_epoch()``
    returns the trainer's stats), synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run_epoch()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    bad = [k for k, v in stats.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite {bad} after {trainer.step} steps")
    return ms, stats


def phase_train_pipeline(report, launches, steps=30):
    """The input pipeline under the trainers at full width:
    (1) configs/sisr_x4.json with add_jpeg + jpeg_in_graph on device data
    (64 seeded uint8 records of 256^2), ``steps`` steps through
    SISRTrainer.run_step_device: exactly K5 x2, K6, K7 a step, each held
    against its plain version on the first step's arguments, the ELBO on
    a fixed batch with fixed draws before and after, ms per step, and
    jpeg_degrade on that step's LR batch on the card (TF32 off and on:
    the same bits) and on the CPU (the tie rule); (2) host JPEG
    (HostSISRSampler, libjpeg) through train_epoch, 10 steps with
    prefetch=2 and 10 with 0: ms per step and the prefetcher's stats;
    (3) configs/denoising_real.json on a pack file of seeded pairs, 10
    steps through PackDBSampler and the prefetcher, 10 through
    DeviceDataset.from_packdb, twice in turns: ms per step and the
    records' bytes on the card."""
    import cv2

    from virnet_tpu_torch.cli.train_sisr import build_trainer
    from virnet_tpu_torch.data import sisr_synth
    from virnet_tpu_torch.data.device_data import DeviceDataset
    from virnet_tpu_torch.data.packdb import PackDBSampler, write_packdb
    from virnet_tpu_torch.data.sisr_host import HostSISRSampler
    from virnet_tpu_torch.data.sources import ImageCache
    from virnet_tpu_torch.ops import blur
    from virnet_tpu_torch.ops import fused_conv as fc
    from virnet_tpu_torch.ops import jpeg

    # a torch.profiler session earlier in the process (phases profile,
    # train_sisr) leaves every later launch dearer on the host
    res = {"launch_us": launch_us()}
    report.setdefault("launch_us", {})["train_pipeline"] = res["launch_us"]
    log(f"[train_pipeline] host cost of one tiny launch now: "
        f"{res['launch_us']:.2f} us")
    rng = np.random.default_rng(12)
    trainer = build_trainer(sisr_config(add_jpeg=True, jpeg_in_graph=True))
    tc = trainer.cfg
    log(f"[train_pipeline] SISR, in-graph JPEG on device data: n_feat "
        f"{tc.n_feat}, batch {tc.batch_size}, HR {tc.hr_size}^2, sf {tc.sf}, "
        f"k {tc.k_size}, bf16 autocast {tc.mixed_precision}, JPEG in graph "
        f"{tc.add_jpeg_in_graph}")
    if ((tuple(tc.n_feat), tc.batch_size, tc.hr_size, tc.sf, tc.k_size) != (
            (96, 160, 224), 16, 192, 4, 21) or not tc.add_jpeg_in_graph
            or trainer.host_batches or trainer.device.type != "cuda"):
        raise AssertionError("train_pipeline: not the full-width in-graph "
                             "JPEG configuration")
    records = textured_records(rng, 64, 256)
    ds = DeviceDataset(records)
    n = tc.batch_size
    fixed = torch.from_numpy(records[:n, :tc.hr_size, :tc.hr_size]).cuda()
    fixed_noise = sisr_noise(n, tc.hr_size, tc.sf, tc.kappa0, 13, "cuda")
    fixed_noise["synth"].update(
        is_jpeg=torch.arange(n, device="cuda") % 2 == 0,
        nlevel_jpeg=torch.full((n,), 5 / 255, device="cuda"),
        qf=torch.tensor([30., 35, 40, 45, 60, 70, 80, 95] * (n // 8),
                        device="cuda"))

    def fixed_elbo():
        return float(trainer.loss_and_grads(fixed, 0, fixed_noise)[0])

    before = fixed_elbo()
    calls = {k: [] for k in BLUR_STEP}
    jpeg_calls = []
    fc.reset_launches()
    with recording(blur, "blur_valid", calls["blur_valid"]), \
            recording(blur, "blur_dx", calls["blur_dx"]), \
            recording(blur, "blur_dw", calls["blur_dw"]), \
            recording(sisr_synth, "jpeg_degrade", jpeg_calls):
        trainer.run_step_device(ds, 0)
    times, last = timed_steps(lambda d: trainer.run_step_device(d, 0),
                              lambda: ds, steps - 1, "train_pipeline")
    torch.cuda.synchronize()
    counts = dict(fc.LAUNCHES)
    launches["train_pipeline"] = counts
    log(f"  launches in {steps} steps {counts}")
    check_step_launches("train_pipeline", counts, BLUR_STEP, steps)
    res["kernels_max_abs_err"] = hold_blur_calls(calls)
    ms = float(np.median(times[-20:]))
    host_fed = report.get("train_sisr", {}).get("ms_per_step")
    log(f"  {ms:.2f} ms per step (median of the last 20), {1e3 / ms:.2f} "
        f"steps/s; host-fed Gaussian step of phase train_sisr in this call: "
        f"{'not run' if host_fed is None else f'{host_fed:.2f} ms'}")
    after = fixed_elbo()
    log(f"  ELBO on the fixed batch with fixed draws: {before:.6g} before, "
        f"{after:.6g} after {trainer.step} steps")
    if not (math.isfinite(after) and after < before):
        raise AssertionError("train_pipeline: the ELBO on the fixed batch "
                             "did not go down")

    # jpeg_degrade on the first step's LR batch: card with TF32 off and
    # on, and the CPU
    if len(jpeg_calls) != 1:
        raise AssertionError(f"train_pipeline: one step called jpeg_degrade "
                             f"{len(jpeg_calls)} times, expected once")
    lr, qf = jpeg_calls[0][0]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        outs = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            outs.append(jpeg.jpeg_degrade(lr, qf))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    cpu = jpeg.jpeg_degrade(lr.cpu(), qf.cpu())
    card = outs[0].cpu()
    differ = float((card != cpu).any(-1).float().mean())
    # the tie rule of tests/test_torch_port_pipeline.py
    untied = int(jpeg._untied(lr.cpu(), qf.cpu(), card, cpu).sum())
    log(f"  jpeg_degrade on the step's LR batch {shape_of(lr)}: TF32 on "
        f"equal to off: {torch.equal(outs[0], outs[1])}; card vs CPU: "
        f"{differ:.4%} of pixels differ, {untied} outside a tie")
    if not torch.equal(outs[0], outs[1]) or untied:
        raise AssertionError("train_pipeline: jpeg_degrade depends on TF32 "
                             "or disagrees with the CPU outside ties")
    res["jpeg"] = dict(shape=list(lr.shape), card_cpu_differ=differ,
                       untied=untied, tf32_equal=True)
    # what device data and the codec add to the step: the same trainer
    # and records, in turns (medians of 10 steps): HR crops handed to
    # run_step as train_sisr does (taken outside the timer), device data
    # with the JPEG branch off, and on
    def hr_crops():
        idx = torch.from_numpy(rng.choice(len(records), n, replace=False))
        return ds.arrays[0][idx.cuda(), :tc.hr_size, :tc.hr_size]

    turns = {"host_fed_gaussian": (hr_crops, trainer.run_step, False),
             "device_gaussian": (lambda: ds, trainer.run_step_device, False),
             "device_jpeg": (lambda: ds, trainer.run_step_device, True)}
    turns_ms = {name: [] for name in turns}
    for _ in range(2):
        for name, (data, step, jpeg_on) in turns.items():
            tc.add_jpeg_in_graph = jpeg_on
            t, _ = timed_steps(lambda d: step(d, 0), data, 10,
                               f"train_pipeline {name}")
            turns_ms[name].append(float(np.median(t)))
    tc.add_jpeg_in_graph = True
    log(f"  in turns, ms per step: {turns_ms}")
    res["jpeg_device_data"] = dict(
        ms_per_step=ms, steps_per_s=1e3 / ms, step_ms=times, last=last,
        elbo_before=before, elbo_after=after, launches=counts,
        host_fed_gaussian_ms=host_fed, turns_ms=turns_ms)
    del trainer, ds

    # (2) host JPEG through the prefetcher and without it
    PIPELINE_DIR.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, im in enumerate(textured_records(rng, 8, 384)):
        paths.append(str(PIPELINE_DIR / f"hr{i}.png"))
        cv2.imwrite(paths[-1], cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    cfg = sisr_config(add_jpeg=True, jpeg_in_graph=False, steps_per_epoch=10)
    trainer = build_trainer(cfg)
    tc = trainer.cfg
    if not trainer.host_batches:
        raise AssertionError("train_pipeline: add_jpeg without jpeg_in_graph "
                             "must feed degraded host batches")
    sampler = HostSISRSampler(
        ImageCache(paths), tc.hr_size, tc.sf, k_size=tc.k_size,
        noise_level=tuple(cfg["noise_level"]),
        noise_jpeg=tuple(cfg["noise_jpeg"]), add_jpeg=True)
    log(f"[train_pipeline] SISR on host JPEG batches (HostSISRSampler, "
        f"libjpeg), {tc.steps_per_epoch} steps a run")
    t0 = time.perf_counter()
    warm = sampler.sample(tc.batch_size)
    sample_ms = (time.perf_counter() - t0) * 1e3
    trainer.run_step(warm, 0)
    host = dict(sample_ms_one_batch=sample_ms)
    fc.reset_launches()
    for depth in (2, 0):
        tc.prefetch = depth
        sampler.reset_seed(depth)
        ms, stats = epoch_ms(trainer, tc.steps_per_epoch, lambda: (
            trainer.train_epoch(0, (sampler.sample(tc.batch_size)
                                    for _ in range(tc.steps_per_epoch)),
                                log_fn=lambda m: None)))
        pf = {k: v for k, v in stats.items() if k.startswith("prefetch_")}
        log(f"  prefetch={depth}: {ms:.1f} ms per step"
            + (f", prefetcher {pf}" if pf else ""))
        host[f"prefetch_{depth}"] = dict(ms_per_step=ms, stats=pf)
    torch.cuda.synchronize()
    counts = dict(fc.LAUNCHES)
    launches["train_pipeline_host_jpeg"] = counts
    log(f"  one host batch sampled in {sample_ms:.1f} ms; launches in "
        f"{2 * tc.steps_per_epoch} steps {counts}")
    check_step_launches("train_pipeline host JPEG", counts, HOST_BLUR_STEP,
                        2 * tc.steps_per_epoch)
    host["launches"] = counts
    res["host_jpeg"] = host
    del trainer, sampler

    # (3) denoising real on a pack file: the native sampler and device data
    trainer = denoise_trainer("real", steps_per_epoch=10)
    tc = trainer.cfg
    gt = textured_records(rng, 64, 256)
    noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(np.uint8)
    pack = PIPELINE_DIR / "train_real.vpk"
    write_packdb(pack, noisy, gt)
    log(f"[train_pipeline] denoising real on a pack of {len(gt)} pairs of "
        f"256^2: batch {tc.batch_size}, patch {tc.patch_size}^2, "
        f"{tc.steps_per_epoch} steps a run")
    sampler = PackDBSampler(pack, tc.patch_size)
    ds = DeviceDataset.from_packdb(pack)
    trainer.run_step(sampler.sample(tc.batch_size, raw=True), 0)
    trainer.run_step_device(ds, 0)
    real = dict(records_bytes_on_card=ds.nbytes, packdb_prefetch=[],
                device_data=[])
    fc.reset_launches()
    for _ in range(2):      # in turns: the native sampler, device data
        ms, stats = epoch_ms(trainer, tc.steps_per_epoch, lambda: (
            trainer.train_epoch(0, (sampler.sample(tc.batch_size, raw=True)
                                    for _ in range(tc.steps_per_epoch)),
                                log_fn=lambda m: None)))
        pf = {k: v for k, v in stats.items() if k.startswith("prefetch_")}
        real["packdb_prefetch"].append(dict(ms_per_step=ms, stats=pf))
        log(f"  PackDBSampler + prefetcher: {ms:.2f} ms per step, "
            f"prefetcher {pf}")
        ms, _ = epoch_ms(trainer, tc.steps_per_epoch, lambda: (
            trainer.train_epoch_device(0, ds, tc.steps_per_epoch,
                                       log_fn=lambda m: None)))
        real["device_data"].append(dict(ms_per_step=ms))
        log(f"  DeviceDataset.from_packdb: {ms:.2f} ms per step")
    torch.cuda.synchronize()
    counts = dict(fc.LAUNCHES)
    launches["train_pipeline_real"] = counts
    log(f"  records on the card {ds.nbytes / 2 ** 20:.1f} MiB; launches in "
        f"{4 * tc.steps_per_epoch} steps {counts}")
    if any(counts.values()):
        raise AssertionError("train_pipeline: the denoising step is built "
                             "on plain convolutions and launches no kernel "
                             "of the package")
    sampler.close()
    res["real"] = real
    report["train_pipeline"] = res


# the bf16 paths take K11 twice for each unconditioned RNet block: 15
# blocks of denoising-syn, 21 of denoising-real, SISR's 4 up-path blocks
SERVE_PATH = {"dncnn_head_fused": 1, "conv3x3_tail_residual": 1,
              "resblock_conv": 30}
SIDD_BF16_PATH = {"dncnn_head_fused": 1, "conv3x3_tail_residual": 1,
                  "resblock_conv": 42}
SIDD_FP32_PATH = {"dncnn_head_fused": 1, "conv3x3_mid": 6,
                  "conv3x3_tail_residual": 1}
K2_PATH = {"dncnn_fused": 1, "conv3x3_mid": 3, "conv3x3_tail_residual": 1}
K2_BF16_PATH = {"syn": dict(K2_PATH, resblock_conv=30),
                "sisr": dict(K2_PATH, resblock_conv=8)}


@contextlib.contextmanager
def counting_forwards():
    """Inside the block every Restorer.restore_batch call adds one to the
    yielded list's only item (the forwards a harness made)."""
    from virnet_tpu_torch.eval.engine import Restorer

    fn = Restorer.restore_batch
    calls = [0]

    def counted(self, x):
        calls[0] += 1
        return fn(self, x)

    Restorer.restore_batch = counted
    try:
        yield calls
    finally:
        Restorer.restore_batch = fn


def harness_path(key, launches, fn, per_forward):
    """Drive a harness once with the launch counters zeroed just before and
    read just after; fail unless each kernel of ``per_forward`` launched
    exactly that many times per forward and nothing else launched."""
    with counting_forwards() as calls:
        out, counts = run_path(key, fn, tuple(per_forward))
    n = calls[0]
    launches[key] = counts
    if n == 0:
        raise AssertionError(f"{key}: the harness made no forward")
    want = {k: v * n for k, v in per_forward.items()}
    got = {k: c for k, c in counts.items() if c}
    log(f"  {key}: {n} forwards; launches per forward "
        f"{ {k: c / n for k, c in got.items()} }")
    if got != want:
        raise AssertionError(f"{key}: {n} forwards launched {got}, expected "
                             f"{want} (per forward {per_forward})")
    return out, n


def sidd_blocks(seed, n_img, n_blk, size=256, sigma=10.0, device="cuda"):
    """A seeded SIDD validation pair in the real layout, (images, blocks,
    size, size, 3) uint8: each image's blocks are shifted orientations of
    one smooth image, the noise N(0, sigma) in uint8 levels, drawn on the
    card."""
    from virnet_tpu_torch.ops.augment import dihedral_np

    rng = np.random.default_rng(seed)
    gt = np.empty((n_img, n_blk, size, size, 3), np.uint8)
    for i in range(n_img):
        im = smooth_image(rng, size, size)
        for j in range(n_blk):
            shifted = np.roll(im, tuple(rng.integers(0, size, 2)), (0, 1))
            gt[i, j] = np.round(dihedral_np(shifted, j % 8) * 255)
    g = torch.Generator(device=device).manual_seed(seed)
    noisy = torch.from_numpy(gt).to(device).float()
    noisy += sigma * torch.randn(noisy.shape, generator=g, device=device)
    return noisy.round().clamp(0, 255).to(torch.uint8).cpu().numpy(), gt


def write_sidd(folder, noisy, gt):
    import scipy.io as sio

    folder.mkdir(parents=True, exist_ok=True)
    # MATLAB files are column-major: savemat writes a Fortran-ordered
    # array as it lies (0.3 s for 250 MB, a C-ordered one ~10 s)
    sio.savemat(str(folder / "ValidationNoisyBlocksSrgb.mat"),
                {"ValidationNoisyBlocksSrgb": np.asfortranarray(noisy)})
    sio.savemat(str(folder / "ValidationGtBlocksSrgb.mat"),
                {"ValidationGtBlocksSrgb": np.asfortranarray(gt)})
    return folder


def host_scores(gt, blocks):
    """Host PSNR and SSIM of every block (eval/metrics.py), on threads."""
    from concurrent.futures import ThreadPoolExecutor

    from virnet_tpu_torch.eval.metrics import calculate_psnr, calculate_ssim

    def score(i):
        return calculate_psnr(gt[i], blocks[i]), calculate_ssim(gt[i],
                                                                blocks[i])

    with ThreadPoolExecutor(8) as pool:
        return np.array(list(pool.map(score, range(len(blocks))))).T


def check_sigma_exact(name, got, plain, args, kw):
    """fp32 sigma of K3 against the exact function: the SNet chain in
    float64 on the card.  On SIDD-like blocks at 128 x 256^2 two f32 orders
    differ by more than check_close's rtol 1e-5 (|logits| reach ~9, where
    an f32 ulp is 9.5e-7, through 8 levels): the plain version itself
    misses the float64 function by ~1.5e-5 in log sigma.  So the kernel's
    log sigma error against float64 must stay within 1e-5 or twice the
    plain f32 version's own error, whichever is larger (an f32 kernel no
    less exact than its plain version; a wrong tap moves log sigma by a
    large part of its scale).  Returns the kernel's error."""
    import torch.nn.functional as F

    def conv64(y, w, b, slope=None):
        y = F.conv2d(y.double().permute(0, 3, 1, 2),
                     w.double().permute(3, 2, 0, 1), b.double(), padding=1)
        y = y if slope is None else F.leaky_relu(y, slope)
        return y.permute(0, 2, 3, 1)

    x, w1, b1, wms, bms, wl, bl = args[:7]
    slope = kw.get("slope", 0.25)
    y = conv64(x, w1, b1, slope)
    for i in range(wms.shape[0]):
        y = conv64(y, wms[i], bms[i], slope)
    exact = conv64(y, wl, bl).clamp(kw.get("lmin", -23.025850929940457),
                                    kw.get("lmax", 4.605170185988092))
    del y
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got.double().log() - exact).abs().max())
    plain_err = float((plain.double().log() - exact).abs().max())
    rel = float(((got.double() - plain.double()).abs()
                 / plain.double().abs()).max())
    tol = max(1e-5, 2 * plain_err)
    ok = err <= tol
    log(f"  {name}: log sigma against float64 {err:.3g}, the plain f32 "
        f"version's {plain_err:.3g} (bar {tol:.3g}); against the plain "
        f"version rel {rel:.3g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel misses the float64 function "
                             f"by {err} (bar {tol})")
    return err


def check_sidd_path_kernels(key, restorer, x):
    """K3 (and in fp32 each K1 level of its chain) and K4 against their
    plain versions on the card, on the arguments one x8 TTA forward of the
    batch ``x`` hands them."""
    from virnet_tpu_torch.eval.tta import tta_x8
    from virnet_tpu_torch.models import attresunet
    from virnet_tpu_torch.ops import fused_conv as fc

    head, tail = [], []
    with recording(fc, "dncnn_head_fused", head), \
            recording(attresunet, "conv3x3_tail_residual", tail):
        tta_x8(restorer.restore_batch, x)
    if len(head) != 1 or len(tail) != 1:
        raise AssertionError(f"one TTA forward called K3 {len(head)} and K4 "
                             f"{len(tail)} times, expected once each")
    (args, kw), = head
    dtype = args[0].dtype
    shape = shape_of(args[0])
    with torch.inference_mode():
        h, s = fc.dncnn_head_fused(*args, **kw)
        ph, ps = fc.dncnn_head_fused_plain(*args, **kw)
        errs = dict(head=check_close(f"{key} K3 head {shape}", h, ph, dtype))
        if dtype == torch.float32:    # fp32 K3 is the level chain
            errs["sigma"] = check_sigma_exact(f"{key} K3 sigma {shape}", s,
                                              ps, args, kw)
            del h, s, ph, ps
            check_levels(key, *args[:5], kw.get("slope", 0.25), errs)
        else:
            errs["sigma"] = check_close(f"{key} K3 sigma {shape}", s, ps,
                                        dtype, kind="sigma")
            del h, s, ph, ps
        check_tail(key, tail, errs)
    return errs


@contextlib.contextmanager
def recording_k2():
    """Inside the block the first call of each input shape to K2 and to K4
    is recorded, as (snet, tail) lists of (args, kwargs)."""
    from virnet_tpu_torch.models import attresunet
    from virnet_tpu_torch.ops import fused_conv as fc

    snet, tail = [], []
    with recording(fc, "dncnn_fused", snet, per_shape=True), \
            recording(attresunet, "conv3x3_tail_residual", tail,
                      per_shape=True):
        yield snet, tail


def check_k2_shapes(key, snet, tail, want):
    """check_k2_calls on a harness's recorded calls, after checking that K2
    saw exactly the (batch, h, w) input shapes ``want``."""
    got = {tuple(a[0].shape[:3]) for a, _ in snet}
    if got != want:
        raise AssertionError(f"{key}: K2 saw input shapes {sorted(got)}, "
                             f"expected {sorted(want)}")
    return check_k2_calls(key, snet, tail)


def table12_noisy_psnr(images, noise_type="niid", seed=1000):
    """Each Table 1/2 case's mean PSNR of the noisy inputs themselves, from
    the harness's own synthesis (one seeded stream, in its order)."""
    from virnet_tpu_torch.data.eval_sets import DenoiseBenchmark
    from virnet_tpu_torch.eval.metrics import calculate_psnr
    from virnet_tpu_torch.ops.quant import img_as_ubyte

    bench = DenoiseBenchmark(noise_type, seed)
    return {str(case): float(np.mean([calculate_psnr(img_as_ubyte(np.clip(
        bench.noisy(im, base), 0.0, 1.0)), im, border=0) for _, im in images]))
        for case, base in bench.cases()}


def ssim_cv2(im1, im2):
    """The host SSIM as it stood before eval/metrics.py dropped cv2:
    cv2.filter2D over the whole image, then the 5-px crop (timed beside
    the port's, not used by it)."""
    import cv2

    g = np.exp(-(np.arange(11) - 5.0) ** 2 / (2 * 1.5 ** 2))
    win = np.outer(g / g.sum(), g / g.sum())
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    vals = []
    for c in range(im1.shape[2]):
        a = im1[..., c].astype(np.float64)
        b = im2[..., c].astype(np.float64)

        def f(m):
            return cv2.filter2D(m, -1, win)[5:-5, 5:-5]

        mu1, mu2 = f(a), f(b)
        s1, s2, s12 = (f(a * a) - mu1 ** 2, f(b * b) - mu2 ** 2,
                       f(a * b) - mu1 * mu2)
        vals.append((((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
            (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))).mean())
    return float(np.mean(vals))


def time_host_ssim(shapes=((256, 256), (321, 481)), reps=20):
    """ms of one host SSIM (eval/metrics.py, numpy) against the cv2
    version it replaced, median of ``reps`` on the host's clock, and their
    difference (bar 1e-12)."""
    from virnet_tpu_torch.eval.metrics import calculate_ssim

    rng = np.random.default_rng(7)
    out = {}
    for h, w in shapes:
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)
        row = {}
        for name, fn in (("numpy_ms", calculate_ssim), ("cv2_ms", ssim_cv2)):
            fn(a, b)
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(a, b)
                ts.append((time.perf_counter() - t0) * 1e3)
            row[name] = float(np.median(ts))
        row["diff"] = abs(calculate_ssim(a, b) - ssim_cv2(a, b))
        log(f"  host SSIM {h}x{w}x3: numpy {row['numpy_ms']:.2f} ms, cv2 "
            f"{row['cv2_ms']:.2f} ms (medians of {reps}); diff "
            f"{row['diff']:.3g} (bar 1e-12)")
        if row["diff"] > 1e-12:
            raise AssertionError("host SSIM disagrees with the cv2 version")
        out[f"{h}x{w}"] = row
    return out


def lpips_file(path, seed=0):
    """Seeded random LPIPS-alex weights saved in the lpips package's key
    layout (no pretrained weights are in the repo)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, (ci, co, ks, idx) in enumerate(((3, 64, 11, 0), (64, 192, 5, 3),
                                           (192, 384, 3, 6), (384, 256, 3, 8),
                                           (256, 256, 3, 10))):
        sd[f"net.slice{k + 1}.{idx}.weight"] = torch.randn(
            co, ci, ks, ks, generator=g) * 0.05
        sd[f"net.slice{k + 1}.{idx}.bias"] = torch.randn(co, generator=g) \
            * 0.05
        sd[f"lin{k}.model.1.weight"] = torch.rand(
            1, co, 1, 1, generator=g) * 0.1
    torch.save(sd, path)
    return path


def phase_eval_tables(report, launches, sidd=(40, 32, 256), fp32_blocks=64,
                      cbsd=(321, 481), hr_hw=(500, 684), device="cuda"):
    """The benchmark harnesses on the card with the demo weights and seeded
    synthetic data (no data set is in the repo; no image file is read).
    Table 4: cli.eval_sidd on 40 x 32 blocks of 256^2 in bf16, x8 TTA as
    one forward of 128 blocks (K3 + RNet + K4), megatime, device against
    host metrics; fp32 on the first 64 blocks; in each compute K3 (and in
    fp32 its K1 levels) and K4 on one forward's arguments; one TTA batch
    against the host ensemble.  Tables 1/2 (niid, each case above its
    noisy input's PSNR) and 5 (x4, 7 kernels, LPIPS card against CPU)
    through K2 + K4 in both computes, K2/K1/K4 held against their plain
    versions on each shape the harness handed them.  The host SSIM against
    its cv2 version.  FLOPs and parameters of the eval command lines."""
    import tempfile

    from virnet_tpu_torch.cli import eval_sidd
    from virnet_tpu_torch.cli.common import log_model_size
    from virnet_tpu_torch.eval import lpips
    from virnet_tpu_torch.eval.engine import Restorer
    from virnet_tpu_torch.eval.tables import (denoise_synthetic_table,
                                              sisr_synthetic_table)
    from virnet_tpu_torch.eval.tta import tta_x8
    from virnet_tpu_torch.ops.quant import img_as_float32

    res = {}
    n_img, n_blk, size = sidd
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        noisy, gt = sidd_blocks(5, n_img, n_blk, size, device=device)
        sidd = write_sidd(tmp / "sidd", noisy, gt)
        res["sidd_setup_s"] = time.perf_counter() - t0
        log(f"[eval_tables] SIDD validation layout {noisy.shape} uint8, "
            f"{res['sidd_setup_s']:.1f} s to make and write")

        log("  Table 4: cli.eval_sidd bf16 --batch 16 --device_metrics (x8 "
            "TTA: 128 x 256^2 a forward)")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, n = harness_path(
            "eval_sidd", launches, lambda: eval_sidd.main([
                "--sidd_dir", str(sidd), "--ckpt_path", str(REAL_CKPT),
                "--compute", "bf16", "--batch", "16", "--device_metrics",
                "--device", device]),
            SIDD_BF16_PATH)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        flat_gt = gt.reshape(-1, size, size, 3)
        flat_noisy = noisy.reshape(flat_gt.shape)
        t0 = time.perf_counter()
        hp, hs = host_scores(flat_gt, out["blocks"])
        host_s = time.perf_counter() - t0
        dp = float(np.abs(out["psnr_per_block"] - hp).max())
        ds = float(np.abs(out["ssim_per_block"] - hs).max())
        res["sidd_bf16"] = dict(
            megatime=out["megatime"], forwards=n, wall_s=wall,
            peak_gib=peak, psnr_device=out["psnr"], ssim_device=out["ssim"],
            psnr_host=float(hp.mean()), ssim_host=float(hs.mean()),
            max_block_psnr_diff=dp, max_block_ssim_diff=ds,
            host_scoring_s=host_s)
        noisy_psnr = float(np.mean(host_scores(flat_gt[:64],
                                               flat_noisy[:64])[0]))
        fwd = out["forward_seconds"]
        res["sidd_bf16"].update(first_forward_s=fwd[0],
                                median_forward_s=float(np.median(fwd[1:])))
        log(f"  megatime {out['megatime']:.4f} s/MP (bf16, x8 TTA, "
            f"{1 / out['megatime']:.2f} restored MP/s); forwards: the first "
            f"{fwd[0]:.3f} s, the median of the rest "
            f"{np.median(fwd[1:]):.4f} s; {wall:.1f} s for the command; "
            f"peak {peak:.2f} GiB")
        log(f"  PSNR/SSIM device {out['psnr']:.4f} / {out['ssim']:.4f}, "
            f"host {hp.mean():.4f} / {hs.mean():.4f} ({host_s:.1f} s on 8 "
            f"threads); largest per-block difference {dp:.3g} dB (bar "
            f"2e-3), {ds:.3g} SSIM (bar 1e-4); noisy input "
            f"{noisy_psnr:.2f} dB")
        if dp > 2e-3 or ds > 1e-4:
            raise AssertionError("eval_sidd: device metrics disagree with "
                                 "the host scorers")
        if not out["psnr"] > noisy_psnr:
            raise AssertionError("eval_sidd: restoration did not raise the "
                                 "PSNR")

        real16 = Restorer("denoising-real", ckpt_path=REAL_CKPT,
                          compute="bf16", device=device)
        x16 = torch.from_numpy(img_as_float32(flat_noisy[:16])).to(device)
        res["sidd_bf16"]["kernels_max_abs_err"] = check_sidd_path_kernels(
            "eval_sidd", real16, x16)
        del real16

        k = fp32_blocks // n_blk
        sub = write_sidd(tmp / "sidd_fp32", noisy[:k], gt[:k])
        fp32_batch = 16
        log(f"  Table 4 subset: cli.eval_sidd fp32 --batch {fp32_batch} on "
            f"the first {k * n_blk} blocks (host metrics)")
        torch.cuda.reset_peak_memory_stats()
        out32, n32 = harness_path(
            "eval_sidd_fp32", launches, lambda: eval_sidd.main([
                "--sidd_dir", str(sub), "--ckpt_path", str(REAL_CKPT),
                "--batch", str(fp32_batch), "--device", device]),
            SIDD_FP32_PATH)
        peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
        res["sidd_fp32_64"] = dict(
            megatime=out32["megatime"], forwards=n32, batch=fp32_batch,
            peak_gib=peak32, psnr=out32["psnr"], ssim=out32["ssim"],
            psnr_bf16_same_blocks=float(
                out["psnr_per_block"][:k * n_blk].mean()))
        fwd = out32["forward_seconds"]
        res["sidd_fp32_64"].update(first_forward_s=fwd[0],
                                   median_forward_s=float(np.median(fwd[1:])))
        log(f"  forwards: the first {fwd[0]:.3f} s, the median of the rest "
            f"{np.median(fwd[1:]):.4f} s")
        log(f"  fp32 megatime {out32['megatime']:.4f} s/MP; peak "
            f"{peak32:.2f} GiB; PSNR {out32['psnr']:.4f} (bf16 on the same "
            f"blocks {res['sidd_fp32_64']['psnr_bf16_same_blocks']:.4f})")

        real32 = Restorer("denoising-real", ckpt_path=REAL_CKPT,
                          device=device)
        res["sidd_fp32_64"]["kernels_max_abs_err"] = check_sidd_path_kernels(
            "eval_sidd_fp32", real32, x16)
        del x16
        blocks4 = img_as_float32(flat_noisy[:4])
        with torch.inference_mode():
            dev = tta_x8(real32.restore_batch,
                         torch.from_numpy(blocks4).to(device)).cpu().numpy()
        host = np.stack([real32.restore_image_tta(b) for b in blocks4])
        e = float(np.abs(dev - host).max())
        res["tta_vs_host_ensemble"] = e
        log(f"  tta_x8 of 4 blocks vs Restorer.restore_image_tta, fp32: max "
            f"diff {e:.3g} (atol 1e-4)")
        if e > 1e-4:
            raise AssertionError("tta_x8 disagrees with the host ensemble")
        del real32

        rng = np.random.default_rng(6)
        cbsd = [(f"{i}", np.round(smooth_image(rng, *hw) * 255).astype(
            np.uint8)) for i, hw in enumerate([cbsd] * 4 + [cbsd[::-1]] * 4)]
        noisy_psnr = table12_noisy_psnr(cbsd)
        res["table12"] = {}
        for compute in ("bf16", "fp32"):
            key = f"table12_{compute}"
            syn = Restorer("denoising-syn", ckpt_path=SYN_CKPT,
                           compute=compute, device=device)
            t0 = time.perf_counter()
            with recording_k2() as (snet, tail):
                tab, n = harness_path(
                    key, launches, lambda: denoise_synthetic_table(
                        syn, {"CBSD68 shapes": cbsd}, "niid",
                        log_fn=lambda m: log("  " + m)),
                    K2_PATH if compute == "fp32" else K2_BF16_PATH["syn"])
            wall = time.perf_counter() - t0
            cases = tab["CBSD68 shapes"]
            res["table12"][compute] = dict(
                forwards=n, wall_s=wall,
                psnr={c: r["psnr"] for c, r in cases.items()},
                noisy_psnr=noisy_psnr,
                seconds={c: r["seconds"] for c, r in cases.items()},
                kernels_max_abs_err=check_k2_shapes(key, snet, tail, {
                    (4,) + hw for hw in ((cbsd[0][1].shape[:2]),
                                         (cbsd[-1][1].shape[:2]))}))
            log(f"  Table 1/2 {compute}: seconds per case "
                f"{ {c: round(r['seconds'], 3) for c, r in cases.items()} }")
            for c, r in cases.items():
                if not r["psnr"] > noisy_psnr[c]:
                    raise AssertionError(
                        f"{key} case {c}: PSNR {r['psnr']:.3f} does not beat "
                        f"the noisy input's {noisy_psnr[c]:.3f}")
            del syn, snet, tail

        hr = [(f"{i}", np.round(smooth_image(rng, *hr_hw) * 255).astype(
            np.uint8)) for i in range(4)]
        hr_key = "x".join(map(str, hr_hw))
        lpips.set_params(lpips.load_lpips_params(str(lpips_file(
            tmp / "lpips_alex.pth"))))
        res["table5"] = {}
        try:
            for compute in ("bf16", "fp32"):
                sr = Restorer("sisr", ckpt_path=SISR_CKPT, sf=4,
                              compute=compute, device=device)
                key = f"table5_{compute}"
                t0 = time.perf_counter()
                with recording_k2() as (snet, tail):
                    tab, n = harness_path(
                        key, launches, lambda: sisr_synthetic_table(
                            sr, {hr_key: hr}, 4, use_lpips=True,
                            log_fn=lambda m: log("  " + m)),
                        K2_PATH if compute == "fp32"
                        else K2_BF16_PATH["sisr"])
                wall = time.perf_counter() - t0
                ks = tab[hr_key]["per_kernel"]
                res["table5"][compute] = dict(
                    forwards=n, wall_s=wall,
                    psnr_y=[k["psnr"] for k in ks],
                    lpips=[k["lpips"] for k in ks],
                    seconds=[k["seconds"] for k in ks],
                    kernels_max_abs_err=check_k2_shapes(key, snet, tail, {
                        (4, hr_hw[0] // 4, hr_hw[1] // 4)}))
                log(f"  Table 5 {compute}: seconds per kernel "
                    f"{[round(k['seconds'], 3) for k in ks]}")
                del sr, snet, tail
            errs = []
            for (_, a), (_, b) in ((hr[0], hr[1]), (hr[2], hr[3])):
                on_card = lpips.lpips_rgb(a, b, device)
                on_cpu = lpips.lpips_rgb(a, b, "cpu")
                log(f"  LPIPS card {on_card!r}, CPU {on_cpu!r}")
                errs.append(abs(on_card - on_cpu) / abs(on_cpu))
            res["lpips_card_vs_cpu_rel"] = max(errs)
            log(f"  LPIPS card vs CPU on two image pairs: max rel diff "
                f"{max(errs):.3g} (rtol 1e-4)")
            if max(errs) > 1e-4:
                raise AssertionError("LPIPS on the card disagrees with the "
                                     "CPU")
        finally:
            lpips.set_params(None)

    res["host_ssim"] = time_host_ssim()
    log("  FLOPs and parameters (cli/eval_denoising_syn, cli/eval_sidd)")
    for task, ckpt in (("denoising-syn", SYN_CKPT),
                       ("denoising-real", REAL_CKPT)):
        log(f"  {task}:")
        log_model_size(types.SimpleNamespace(info=lambda m: log("    " + m)),
                       Restorer(task, ckpt_path=ckpt, device=device))
    report["eval_tables"] = res


RUNTIME_DIR = ROOT / "build" / "chip_smoke_runtime"
SHARD_PATH = {"dncnn_fused": 1, "conv3x3_tail_residual": 1}


def wall_ms(fn, reps=1):
    """Host ms per call of ``fn``, synchronised on both ends (one call
    first, unmeasured); returns (ms, the last call's result)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def peak_ms(fn, reps=1):
    """(peak bytes of one call, ms per call by wall_ms, result)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms, out = wall_ms(fn, reps)
    return peak, ms, out


def check_exact(name, got, want):
    """Two bit patterns that must be one: fails with the largest
    difference otherwise."""
    if not torch.equal(got, want):
        d = float((got.double() - want.double()).abs().max())
        raise AssertionError(f"{name}: differs (max abs {d:.3g}), expected "
                             f"the same bits")


def shard_case(key, launches, restorer, im, mesh, halo, out_hw):
    """restore_image_sharded of ``im`` on ``mesh`` by an fp32 Restorer
    against the raw whole-image forward (restore_batch) on the same card:
    launches of the sharded run (exactly one K2 chain and one K4: one
    stage batch on one card), K2, its K1 levels and K4 against their plain
    versions on the sharded run's own arguments, the max abs difference
    (bar 1e-5), and the peak memory and ms of each route.  Returns (the
    results, the sharded image, the whole image)."""
    from virnet_tpu_torch.models import attresunet
    from virnet_tpu_torch.ops import fused_conv as fc

    def whole():
        return restorer.restore_batch(im[None])[0]

    def sharded():
        return restorer.restore_image_sharded(im, mesh, halo=halo)

    out, counts = run_path(key, sharded, tuple(SHARD_PATH))
    launches[key] = counts
    check_image(key, out, out_hw)
    check_shard_launches(key, counts)
    snet, tail = [], []
    with recording(fc, "dncnn_fused", snet), \
            recording(attresunet, "conv3x3_tail_residual", tail):
        sharded()
    errs = check_k2_calls(key, snet, tail)
    p_w, ms_w, w = peak_ms(whole)
    w = w.cpu().numpy()
    p_s, ms_s, s = peak_ms(sharded)
    err = float(np.abs(s - w).max())
    res = dict(max_abs=err, whole_ms=ms_w, sharded_ms=ms_s,
               whole_peak_bytes=p_w, sharded_peak_bytes=p_s,
               launches=counts, kernels_max_abs_err=errs)
    log(f"  {key}: sharded vs whole max abs {err:.3g} (bar 1e-5); whole "
        f"{ms_w:.1f} ms, peak {p_w / 2 ** 30:.2f} GiB; sharded "
        f"{ms_s:.1f} ms, peak {p_s / 2 ** 30:.2f} GiB")
    if err > 1e-5:
        raise AssertionError(f"{key}: sharded restore misses the whole "
                             f"image by {err} (bar 1e-5)")
    return res, s, w


def check_shard_launches(key, counts):
    extra = {k: n for k, n in counts.items()
             if k not in ("conv3x3_mid",) and n != SHARD_PATH.get(k, 0)}
    if extra:
        raise AssertionError(f"{key}: the sharded restore launched {extra}, "
                             f"expected exactly {SHARD_PATH} (one stage "
                             f"batch each on one card)")


def shard_as_fp32(key, launches, restorer, im, mesh, halo, fp32_sharded,
                  fp32_whole):
    """restore_image_sharded of a bf16 or int8 Restorer: the strips run
    fp32 whatever the compute, so the fp32 route's launches (one K2 chain,
    one K4) and the fp32 Restorer's sharded bits, within 1e-5 of the fp32
    whole image; its ms."""
    out, counts = run_path(key, lambda: restorer.restore_image_sharded(
        im, mesh, halo=halo), tuple(SHARD_PATH))
    launches[key] = counts
    check_shard_launches(key, counts)
    check_exact(f"{key} against the fp32 Restorer's sharded restore",
                torch.from_numpy(out), torch.from_numpy(fp32_sharded))
    err = float(np.abs(out - fp32_whole).max())
    ms, _ = wall_ms(lambda: restorer.restore_image_sharded(im, mesh,
                                                           halo=halo))
    log(f"  {key}: the fp32 Restorer's sharded bits; against the fp32 "
        f"whole image max abs {err:.3g} (bar 1e-5); {ms:.1f} ms")
    if err > 1e-5:
        raise AssertionError(f"{key}: misses the fp32 whole image by {err}")
    return dict(max_abs=err, equal_to_fp32_sharded=True, sharded_ms=ms,
                launches=counts)


def runtime_sharded(res, launches):
    """Row-sharded restores on mesh = [cuda:0] * 4 at full width with the
    demo weights: denoising syn and real on a seeded smooth 2048x1536
    image with sigma=15/255 noise (halo 160), SISR x4 on a 384x512 LR
    image to 1536x2048 (halo 64, noise_avg); fp32, then bf16 and int8,
    whose strips run fp32 (``shard_as_fp32``)."""
    from virnet_tpu_torch.eval.engine import Restorer
    from virnet_tpu_torch.train.mesh import Mesh

    mesh = Mesh(["cuda:0"] * 4)
    clean = smooth_image(np.random.default_rng(20), 2048, 1536)
    noisy = (clean + np.random.default_rng(21).normal(
        0, 15 / 255, clean.shape)).astype(np.float32)
    hr = smooth_image(np.random.default_rng(22), 1536, 2048)
    lr = np.ascontiguousarray(hr[1::4, 1::4] + np.random.default_rng(
        23).normal(0, 5 / 255, (384, 512, 3))).astype(np.float32)
    out = {}
    for task, ckpt, im, halo, out_hw, sf in (
            ("denoising-syn", SYN_CKPT, noisy, 160, noisy.shape, 2),
            ("denoising-real", REAL_CKPT, noisy, 160, noisy.shape, 2),
            ("sisr", SISR_CKPT, lr, 64, (1536, 2048, 3), 4)):
        tag = task.split("-")[-1]
        size = "x".join(map(str, im.shape[:2]))
        log(f"[runtime] row-sharded {task} fp32 {size} on [cuda:0] x 4, "
            f"halo {halo}")
        r = Restorer(task, ckpt_path=ckpt, sf=sf, compute="fp32")
        key = f"runtime_shard_{tag}_fp32"
        out[key], s32, w32 = shard_case(key, launches, r, im, mesh, halo,
                                        out_hw)
        del r
        for compute in ("bf16", "int8"):
            log(f"[runtime] row-sharded {task} {compute} (fp32 strips)")
            r = Restorer(task, ckpt_path=ckpt, sf=sf, compute=compute)
            key = f"runtime_shard_{tag}_{compute}"
            out[key] = shard_as_fp32(key, launches, r, im, mesh, halo, s32,
                                     w32)
            del r
    res["sharded"] = out


def runtime_dp_restore(res, launches):
    """Restorer(compute='bf16', mesh=[cuda:0] * 2) on the flagship 33 x
    256^2 batch (repeat-padded to 34, two chunks of 17) against no mesh:
    per image within 4 bf16 ulps of the scale (check_close), exactly K3 +
    K4 once per chunk, each held against its plain version on a chunk's
    own arguments, ms of each."""
    from virnet_tpu_torch.eval.engine import Restorer
    from virnet_tpu_torch.models import attresunet
    from virnet_tpu_torch.ops import fused_conv as fc
    from virnet_tpu_torch.train.mesh import Mesh

    log("[runtime] data-parallel restore_batch 33x256^2 bf16 on "
        "[cuda:0] x 2")
    x = torch.from_numpy(np.random.default_rng(24).random(
        (33, 256, 256, 3), dtype=np.float32)).cuda()
    plain = Restorer("denoising-syn", ckpt_path=SYN_CKPT, compute="bf16")
    meshed = Restorer("denoising-syn", ckpt_path=SYN_CKPT, compute="bf16",
                      mesh=Mesh(["cuda:0"] * 2))
    want = plain.restore_batch(x)
    got, counts = run_path("runtime_dp_restore",
                           lambda: meshed.restore_batch(x), tuple(SERVE_PATH))
    launches["runtime_dp_restore"] = counts
    check_launches("runtime_dp_restore (the serve path once per chunk)",
                   counts, {k: 2 * n for k, n in SERVE_PATH.items()})
    err = check_close("runtime_dp_restore mesh vs no mesh, all 33 images",
                      got, want, torch.bfloat16)
    head, tail = [], []
    with recording(fc, "dncnn_head_fused", head), \
            recording(attresunet, "conv3x3_tail_residual", tail):
        meshed.restore_batch(x)
    errs = {}
    with torch.inference_mode():
        for i, (args, kw) in enumerate(head):
            h, s = fc.dncnn_head_fused(*args, **kw)
            ph, ps = fc.dncnn_head_fused_plain(*args, **kw)
            errs[f"K3 head chunk {i}"] = check_close(
                f"runtime_dp_restore K3 head chunk {i} {shape_of(args[0])}",
                h, ph, torch.bfloat16)
            errs[f"K3 sigma chunk {i}"] = check_close(
                f"runtime_dp_restore K3 sigma chunk {i}", s, ps,
                torch.bfloat16, kind="sigma")
        check_tail("runtime_dp_restore", tail, errs)
    ms_plain = wall_ms(lambda: plain.restore_batch(x), 3)[0]
    ms_mesh = wall_ms(lambda: meshed.restore_batch(x), 3)[0]
    log(f"  {ms_plain:.2f} ms without a mesh, {ms_mesh:.2f} ms on "
        f"[cuda:0] x 2 (34 images, two launches of each kernel)")
    res["dp_restore"] = dict(max_abs=err, launches=counts,
                             kernels_max_abs_err=errs, ms_plain=ms_plain,
                             ms_mesh=ms_mesh)


def traced_steps(trainer, batches) -> dict:
    """``run_step``'s work on each batch, keeping the losses, the
    launches, the first step's averaged gradients (before the clip) and
    the parameters after each step, on the host."""
    from virnet_tpu_torch.ops import fused_conv as fc

    out = dict(losses=[], launches=[], params=[])
    for i, batch in enumerate(batches):
        fc.reset_launches()
        loss, _ = trainer.loss_and_grads(batch, 0)
        if i == 0:
            out["grads"] = {n: p.grad.detach().cpu().clone()
                            for n, p in trainer.model.named_parameters()}
        trainer.optim.step()
        if i == 0:
            # |the first update's clipped gradient| from Adam's state
            adam = trainer.optim.adam
            (_, beta2), = {g["betas"] for g in adam.param_groups}
            out["adam_eps"] = adam.param_groups[0]["eps"]
            out["lr"] = adam.param_groups[0]["lr"]
            out["clipped"] = {
                n: (adam.state[p]["exp_avg_sq"] / (1 - beta2)).sqrt().cpu()
                for n, p in trainer.model.named_parameters()}
        trainer.step += 1
        torch.cuda.synchronize()
        out["launches"].append(dict(fc.LAUNCHES))
        out["losses"].append(float(loss))
        out["params"].append({k: v.detach().cpu().clone() for k, v in
                              trainer.model.state_dict().items()})
    return out


def _rank_run(rank, world, port, out_path, steps):
    """One rank of the two-rank SISR run (spawned): gloo over the one
    card, fp32 (mixed_precision off), ``traced_steps`` over the global
    batches of ``dp_batches``, saved to ``out_path``."""
    sys.path.insert(0, str(ROOT))
    from virnet_tpu_torch.cli.train_sisr import build_trainer
    from virnet_tpu_torch.train import mesh as mesh_mod

    torch.cuda.set_device(0)
    mesh_mod.init_multihost(f"localhost:{port}", world, rank,
                            backend="gloo", timeout_s=300)
    try:
        mesh = mesh_mod.make_mesh(["cuda:0"])
        trainer = build_trainer(sisr_config(mixed_precision=False),
                                mesh=mesh)
        out = traced_steps(trainer, dp_batches(steps))
        out["rows"] = mesh.rows(trainer.cfg.batch_size)
        torch.save(out, out_path)
    finally:
        torch.distributed.destroy_process_group()


def max_diff(a: dict, b: dict) -> tuple:
    """(max abs difference, its tensor's name, that tensor's max abs in
    ``b``) over two dicts of tensors."""
    return max((float((a[k] - v).abs().max()), k, float(v.abs().max()))
               for k, v in b.items())


def dp_batches(steps):
    """The seeded global HR batches (16 x 192^2) of the data-parallel
    runs, on the card."""
    rng = np.random.default_rng(25)
    pool = torch.from_numpy(smooth_batch(rng, 24, 192)).cuda()
    return [pool[torch.from_numpy(rng.choice(24, 16, replace=False)).cuda()]
            for _ in range(steps)]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def runtime_dp_train(res, launches, steps1=10, steps2=5):
    """The data-parallel SISR step of configs/sisr_x4.json at full width
    (16 x 192^2, k 21): world 1 on NCCL in this process against the plain
    trainer (``steps1`` steps, the same bits; K5 x2, K6, K7 a step, each
    held against its plain version on a step's own arguments; ms per step
    of each, in turns), then two ranks spawned on the one card over gloo
    (8 rows each, fp32) against one process, ``steps2`` steps: losses
    rtol 1e-5, parameters atol 1e-5, the ranks' losses equal."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from virnet_tpu_torch.cli.train_sisr import build_trainer
    from virnet_tpu_torch.ops import blur
    from virnet_tpu_torch.ops import fused_conv as fc
    from virnet_tpu_torch.train import mesh as mesh_mod

    log(f"[runtime] SISR step, world 1 on NCCL against the plain trainer, "
        f"{steps1} steps")
    world = mesh_mod.init_multihost(f"localhost:{free_port()}", 1, 0,
                                    backend="nccl")
    out = {}
    try:
        mesh = mesh_mod.make_mesh(["cuda:0"])
        if (world, mesh.world, mesh.grouped) != (1, 1, True):
            raise AssertionError("runtime: no NCCL group of one process")
        plain = build_trainer(sisr_config())
        dp = build_trainer(sisr_config(), mesh=mesh)
        batches = dp_batches(steps1)
        for name, tr in (("plain", plain), ("world1", dp)):
            losses = [float(tr.run_step(b, 0)["loss"]) for b in batches]
            out[f"{name}_losses"] = losses
        for k, v in plain.model.state_dict().items():
            check_exact(f"runtime world 1 vs plain, {k}",
                        dp.model.state_dict()[k], v)
        if out["plain_losses"] != out["world1_losses"]:
            raise AssertionError("runtime: world 1 losses differ from the "
                                 "plain trainer's")
        log(f"  {steps1} steps: parameters and losses bitwise equal "
            f"(last loss {out['plain_losses'][-1]:.6g})")
        calls = {k: [] for k in BLUR_STEP}
        fc.reset_launches()
        with recording(blur, "blur_valid", calls["blur_valid"]), \
                recording(blur, "blur_dx", calls["blur_dx"]), \
                recording(blur, "blur_dw", calls["blur_dw"]):
            dp.run_step(batches[0], 0)
        torch.cuda.synchronize()
        counts = dict(fc.LAUNCHES)
        launches["runtime_dp_train"] = counts
        check_step_launches("runtime_dp_train", counts, BLUR_STEP, 1)
        out["kernels_max_abs_err"] = hold_blur_calls(calls)
        grads = [p.grad for p in dp.optim.params]
        out["all_reduce_ms"] = wall_ms(
            lambda: mesh.all_reduce_mean_(grads), 10)[0]
        log(f"  one all-reduce of the {sum(g.numel() for g in grads)} "
            f"gradients (NCCL, one process): {out['all_reduce_ms']:.3f} ms")
        turns = []
        for name, tr in (("plain", plain), ("world1", dp), ("world1", dp),
                         ("plain", plain)):
            times, _ = timed_steps(lambda b: tr.run_step(b, 0),
                                   lambda: batches[1], 5, name)
            turns.append((name, float(np.median(times))))
        out["ms_turns"] = turns
        log(f"  ms per step in turns: "
            + ", ".join(f"{n} {m:.2f}" for n, m in turns))
        del plain, dp
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    log(f"[runtime] SISR step, two ranks on the one card over gloo (8 rows "
        f"each, fp32) against one process, {steps2} steps")
    RUNTIME_DIR.mkdir(parents=True, exist_ok=True)
    files = [RUNTIME_DIR / f"rank{r}.pt" for r in range(2)]
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_run,
                         args=(r, 2, port, files[r], steps2))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"runtime: a rank failed "
                             f"{[p.exitcode for p in procs]}")
    ranks = [torch.load(f, weights_only=False) for f in files]
    one = build_trainer(sisr_config(mixed_precision=False))
    ref = traced_steps(one, dp_batches(steps2))
    del one
    r0 = ranks[0]
    if r0["losses"] != ranks[1]["losses"]:
        raise AssertionError("runtime: the two ranks report other losses")
    for step, (a, b) in enumerate(zip(r0["params"], ranks[1]["params"])):
        for k, v in a.items():
            check_exact(f"runtime rank 0 vs rank 1, step {step}, {k}",
                        b[k], v)
    rel = max(rel_err(a, b) for a, b in zip(r0["losses"], ref["losses"]))
    per_step = [max_diff(a, b) for a, b in zip(r0["params"], ref["params"])]
    g_err, g_name, g_max = max(
        (float((r0["grads"][k] - v).abs().max()) / max(float(
            v.abs().max()), 1e-30), k, float(v.abs().max()))
        for k, v in ref["grads"].items())
    for r in ranks:
        for c in r["launches"]:
            check_step_launches("runtime two ranks", c, BLUR_STEP, 1)
    perr = per_step[-1][0]
    # Adam's first update is lr * g / (|g| + eps) of the clipped gradient
    # g: where |g| is within a hundred eps it depends on |g| itself, and
    # float sums in another order (two half batches against one) move it
    # by up to a tenth of a step.  Elsewhere the parameters must agree
    # within 1e-5; there, within the steps' reach (2 lr a step).
    eps_regime = 100 * ref["adam_eps"]
    reach = 2 * ref["lr"] * len(ref["params"])
    n_el = sum(v.numel() for v in ref["params"][0].values())
    over, outside = [], []
    for a, b in zip(r0["params"], ref["params"]):
        past = {k: (a[k] - v).abs() > 1e-5 for k, v in b.items()}
        over.append(sum(int(m.sum()) for m in past.values()))
        for k, m in past.items():
            if m.any():
                g = ref["clipped"][k][m]
                d = (a[k] - b[k]).abs()[m]
                outside += [(k, float(x), float(y)) for x, y in zip(g, d)
                            if x >= eps_regime or y > reach]
    name = per_step[0][1]
    worst = int((r0["params"][0][name] - ref["params"][0][name]).abs()
                .argmax())
    g_worst = (float(r0["grads"][name].flatten()[worst]),
               float(ref["grads"][name].flatten()[worst]),
               float(ref["clipped"][name].flatten()[worst]))
    log(f"  elements past 1e-5 after each step {over} of {n_el}, every one "
        f"with a first clipped gradient under 100 eps ({eps_regime:.3g}) and "
        f"within 2 lr a step: {not outside}; the worst ({name} [{worst}]): "
        f"first-step gradients {g_worst[0]:.6g} (two ranks), "
        f"{g_worst[1]:.6g} (one process), clipped {g_worst[2]:.3g}")
    out.update(elements_past_1e5=over, elements=n_el,
               worst_element_grads=g_worst, outside_eps_regime=outside[:10])
    log(f"  rows {[r['rows'] for r in ranks]}; losses {r0['losses']} (one "
        f"process {ref['losses']}); max rel diff {rel:.3g} (rtol 1e-5); the "
        f"ranks' parameters the same bits; first step's averaged gradients "
        f"against one process: max abs diff / the tensor's max abs {g_err:.3g}"
        f" ({g_name}, max abs {g_max:.3g}); parameters after each step: "
        + "; ".join(f"{d:.3g} ({n}, max abs {m:.3g})"
                    for d, n, m in per_step)
        + " (atol 1e-5); K5 x2, K6, K7 a step a rank")
    out.update(two_rank_losses=r0["losses"],
               one_process_losses=ref["losses"], loss_rel=rel,
               param_abs=perr, param_abs_per_step=per_step,
               grad_rel=(g_err, g_name, g_max),
               two_rank_launches=r0["launches"][0])
    res["dp_train"] = out
    if rel > 1e-5 or outside:
        raise AssertionError(f"runtime: two ranks miss the one-process run "
                             f"(loss rel {rel}; {outside[:5]})")


def runtime_remat(res):
    """The denoising syn and SISR steps at the configs' sizes (16 x 128^2,
    16 x 192^2, bf16 autocast) with remat on against off: the loss and
    every gradient the same bits; peak memory and ms of a forward and
    backward, in turns."""
    from virnet_tpu_torch.cli.train_sisr import build_trainer

    out = {}
    rng = np.random.default_rng(26)
    for kind in ("syn", "sisr"):
        log(f"[runtime] remat on against off, {kind} step")
        if kind == "sisr":
            trs = {r: build_trainer(sisr_config(remat=bool(r)))
                   for r in (0, 1)}
            batch = torch.from_numpy(smooth_batch(rng, 16, 192)).cuda()
            noise = sisr_noise(16, 192, 4, 50.0, 27, "cuda")
        else:
            trs = {r: denoise_trainer("syn", remat=bool(r))
                   for r in (0, 1)}
            batch = torch.from_numpy(smooth_batch(rng, 16, 128)).cuda()
            noise = denoise_draws("syn", 16, 128, 27, "cuda")
        grads = {}
        for r, tr in trs.items():
            if tr.model.RNet.remat != bool(r):
                raise AssertionError("runtime: remat not taken from the "
                                     "config")
            loss, _ = tr.loss_and_grads(batch, 0, noise)
            grads[r] = (loss, {n: p.grad.clone() for n, p in
                               tr.model.named_parameters()})
        check_exact(f"remat {kind} loss", grads[1][0], grads[0][0])
        for n, g in grads[0][1].items():
            check_exact(f"remat {kind} gradient {n}", grads[1][1][n], g)
        del grads
        turns = []
        for r in (0, 1, 1, 0):
            peak, ms, _ = peak_ms(
                lambda: trs[r].loss_and_grads(batch, 0, noise), 3)
            turns.append(dict(remat=bool(r), ms=ms, peak_bytes=peak))
        log("  loss and every gradient bitwise equal; in turns: " + ", ".join(
            f"{'on' if t['remat'] else 'off'} {t['ms']:.2f} ms "
            f"{t['peak_bytes'] / 2 ** 30:.2f} GiB" for t in turns))
        out[kind] = turns
        del trs
        torch.cuda.empty_cache()
    res["remat"] = out


def runtime_determinism(res, steps=6):
    """The trainers' contract is bitwise resume.  The synthetic denoising
    and the SISR steps at full width, each run twice from the same seed
    for ``steps`` steps, with the step's flag scope as it is
    (precision.train_step_mode: cuDNN deterministic) and with TF32 off
    alone (precision.parity_mode): the parameters of the two runs must be
    the same bits in the first case, and are counted in the second; then
    ms per step of the two scopes in turns."""
    from virnet_tpu_torch import precision
    from virnet_tpu_torch.cli.train_sisr import build_trainer
    from virnet_tpu_torch.train import loop_denoise, loop_sisr

    def scope(det):
        mode = precision.train_step_mode if det else precision.parity_mode
        loop_denoise.train_step_mode = loop_sisr.train_step_mode = mode

    rng = np.random.default_rng(29)
    out = {}
    try:
        for kind in ("syn", "sisr"):
            size = 192 if kind == "sisr" else 128
            pool = torch.from_numpy(smooth_batch(rng, 16, size)).cuda()

            def build():
                return (build_trainer(sisr_config()) if kind == "sisr"
                        else denoise_trainer("syn"))
            rec = {}
            for det in (False, True):
                scope(det)
                states = []
                for _ in range(2):
                    tr = build()
                    for i in range(steps):
                        tr.run_step(pool.roll(i, 0), 0)
                    states.append({k: v.clone() for k, v in
                                   tr.model.state_dict().items()})
                    del tr
                rec[f"differ_{'det' if det else 'tf32_off_only'}"] = sum(
                    not torch.equal(states[0][k], v)
                    for k, v in states[1].items())
            if rec["differ_det"]:
                raise AssertionError(f"runtime: two runs of the {kind} step "
                                     f"differ in {rec['differ_det']} "
                                     f"tensors")
            tr = build()
            turns = []
            for det in (False, True, True, False):
                scope(det)
                times, _ = timed_steps(lambda b: tr.run_step(b, 0),
                                       lambda: pool, 6, kind)
                turns.append(dict(deterministic=det,
                                  ms=float(np.median(times[1:]))))
            del tr
            rec["ms_turns"] = turns
            log(f"[runtime] determinism, {kind} step: two runs of {steps} "
                f"steps differ in {rec['differ_tf32_off_only']} tensors with "
                f"TF32 off alone, {rec['differ_det']} with cuDNN "
                f"deterministic; ms per step in turns: " + ", ".join(
                    f"{'det' if t['deterministic'] else 'tf32 off'} "
                    f"{t['ms']:.2f}" for t in turns))
            out[kind] = rec
    finally:
        scope(True)
    res["determinism"] = out


def runtime_resilience(res):
    """cli/resilience_proof at full width: configs/denoising_syn.json on
    16 seeded 256^2 PNGs, 2 epochs x 20 steps, SIGKILLed at epoch 2 step
    10 and resumed; the final checkpoints must be the same bits."""
    import cv2

    from virnet_tpu_torch.cli import resilience_proof

    log("[runtime] kill/resume proof, denoising syn at full width, 2 x 20 "
        "steps, killed at epoch 2 step 10")
    folder = RUNTIME_DIR / "images"
    folder.mkdir(parents=True, exist_ok=True)
    for i, im in enumerate(textured_records(np.random.default_rng(28), 16,
                                            256)):
        cv2.imwrite(str(folder / f"{i:02d}.png"), im[..., ::-1])
    t0 = time.perf_counter()
    out = resilience_proof.main([
        "--config", str(DENOISE_CONFIGS["syn"]), "--epochs", "2",
        "--steps_per_epoch", "20", "--kill_step", "10", "--work_dir",
        str(RUNTIME_DIR / "proof"), "--timeout_s", "300",
        "--override", f'train_data=[["{folder}", "*.png"]]',
        "--override", "val_data=", "--override", "print_freq=1"])
    out["wall_s"] = time.perf_counter() - t0
    log(f"  {json.dumps(out)}")
    res["resilience"] = out


def runtime_endurance(res, minutes=0.5):
    """cli/endurance --mode real for ``minutes``, through the pack and the
    prefetcher, then with --device_data."""
    from virnet_tpu_torch.cli import endurance

    out = {}
    for extra in ([], ["--device_data"]):
        name = "device_data" if extra else "pack"
        log(f"[runtime] endurance --minutes {minutes} --mode real ({name})")
        out[name] = endurance.main([
            "--minutes", str(minutes), "--mode", "real", "--pack_records",
            "256", "--save_dir", str(RUNTIME_DIR / "endurance"),
            "--sync_every", "100"] + extra)
        if not out[name]["final_loss_finite"] or out[name]["steps"] < 1:
            raise AssertionError(f"runtime endurance {name}: {out[name]}")
    res["endurance"] = out


def phase_runtime(report, launches):
    """The multi-device and runtime modules on the card."""
    res = {}
    report["runtime"] = res
    runtime_sharded(res, launches)
    runtime_dp_restore(res, launches)
    runtime_remat(res)
    runtime_determinism(res)
    runtime_resilience(res)
    runtime_endurance(res)
    runtime_dp_train(res, launches)


INT8_DIR = ROOT / "build" / "chip_smoke_int8"
# the convolutions that the int8 gate takes in one forward of each preset
# (tests/test_torch_port_int8.py FULL), one K10 and one K9 launch each
INT8_GATED = {"denoising-syn": 33, "denoising-real": 48, "sisr": 71}


@contextlib.contextmanager
def recording_q8(calls, absmax_calls):
    """Inside the block ops/qconv.conv_q8 (K9's wrapper) and absmax_nhwc
    (K10's) keep the arguments of their first call of each shape (K9: the
    input and weight shapes; K10: the input shape) and how many calls had
    it, and compute as before."""
    from virnet_tpu_torch.ops import qconv

    q8, am = qconv.conv_q8, qconv.absmax_nhwc

    def rec_q8(x, sx, kq, sw, bias=None, out_dtype=torch.float32):
        key = (tuple(x.shape), tuple(kq.shape))
        if key not in calls:
            calls[key] = [(x, sx, kq, sw, bias, out_dtype), 0]
        calls[key][1] += 1
        return q8(x, sx, kq, sw, bias, out_dtype)

    def rec_am(x):
        key = tuple(x.shape)
        if key not in absmax_calls:
            absmax_calls[key] = [x, 0]
        absmax_calls[key][1] += 1
        return am(x)

    qconv.conv_q8, qconv.absmax_nhwc = rec_q8, rec_am
    try:
        yield
    finally:
        qconv.conv_q8, qconv.absmax_nhwc = q8, am


def int_mm_route(xq, kq, sw, bias, out_dtype):
    """The int8 product through torch._int_mm behind an im2col (the library
    yardstick, used nowhere in the port): the k*k shifted views of the
    zero-padded int8 input side by side, (N*H*W, k*k*Ci), zero-padded to
    _int_mm's multiples, times the (k*k*Ci, Co) weights, then the
    dequantizing epilogue of the plain version."""
    import torch.nn.functional as F

    n, h, w, ci = xq.shape
    k, co = kq.shape[0], kq.shape[3]
    p = k // 2
    xp = F.pad(xq, (0, 0, p, p, p, p))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(k)
                      for dx in range(k)], dim=3).reshape(n * h * w,
                                                         k * k * ci)
    wm = kq.reshape(k * k * ci, co)
    m, kk = cols.shape
    mp, kp, cp = max(-(-m // 8) * 8, 24), -(-kk // 8) * 8, -(-co // 8) * 8
    cols = F.pad(cols, (0, kp - kk, 0, mp - m))
    wm = F.pad(wm, (0, cp - co, 0, kp - kk)).t().contiguous().t()
    acc = torch._int_mm(cols, wm)[:m, :co]
    y = acc.float() * sw
    if bias is not None:
        y = y + bias
    return y.to(out_dtype).reshape(n, h, w, co)


def int8_kernel_checks(calls, absmax_calls, res, peaks):
    """K9 against its plain version (quantize_with then the int8 product)
    and the library route (the same quantize, then im2col + _int_mm) on
    each recorded (tag, input, weight) shape: the dequantized output bit
    for bit on the recorded arguments, the int32 sums bit for bit on
    integers in [-8, 8] of the same shapes fed as float with scale 1 (q =
    x; |acc| <= 64 k^2 Ci < 2^24, so float32 holds them exactly); then
    cold ms of each beside the bound (int8 tensor-core peak; each input
    read once, the output written once).  K10 against its plain version
    bit for bit on each recorded input, cold ms beside its bound (bytes)
    and torch.linalg.vector_norm(x, inf) (library_ms)."""
    from virnet_tpu_torch.ops import qconv

    gen = torch.Generator(device="cuda").manual_seed(41)
    k9, k10 = res.setdefault("conv_w8a8", {}), res.setdefault(
        "absmax_nhwc", {})
    for (tag, xs, ks), ((x, sx, kq, sw, bias, dt), count) in calls.items():
        n, h, w, ci = xs
        k, co = ks[0], ks[3]
        name = f"{tag} {'x'.join(map(str, xs))} k{k} {co}"
        plan = qconv.conv_q8_plan(k, ci, co, dt)
        got = qconv.conv_q8(x, sx, kq, sw, bias, dt)
        want = qconv.conv_q8_plain(x, sx, kq, sw, bias, dt)
        lib = int_mm_route(qconv.quantize_with(x, sx), kq, sw, bias, dt)
        xs8 = torch.randint(-8, 9, xs, generator=gen, device="cuda").to(
            x.dtype)
        ks8 = torch.randint(-8, 9, ks, generator=gen, device="cuda",
                            dtype=torch.int8)
        ones = torch.ones(co, device="cuda")
        sums = qconv.conv_q8(xs8, torch.ones(ci, device="cuda"), ks8, ones,
                             None, torch.float32)
        sums_want = qconv.int32_sums(xs8.to(torch.int8), ks8,
                                     k // 2).float()
        torch.cuda.synchronize()
        ok = (torch.equal(got, want) and torch.equal(sums, sums_want)
              and torch.equal(lib, want))
        log(f"  K9 {name} (x{count}, co_blk {plan['co_blk']} x "
            f"{plan['splits']}, last {plan['tail']}, "
            f"{plan['smem_bytes']} B): output, int32 sums "
            f"and the library route {'bit for bit' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError(f"int8: K9 disagrees with its plain "
                                 f"version at {name}: output max diff "
                                 f"{max_err(got, want)}, sums "
                                 f"{max_err(sums, sums_want)}, library "
                                 f"{max_err(lib, want)}")
        del xs8, ks8, sums, sums_want, lib
        ms = time_cold_ms(lambda: qconv.conv_q8(x, sx, kq, sw, bias, dt), 5)
        plain_ms = time_cold_ms(
            lambda: qconv.conv_q8_plain(x, sx, kq, sw, bias, dt), 2,
            warmup=1)
        library_ms = time_cold_ms(
            lambda: int_mm_route(qconv.quantize_with(x, sx), kq, sw, bias,
                                 dt), 3, warmup=1)
        flops = 2.0 * n * h * w * k * k * ci * co
        nbytes = (n * h * w * (ci * x.element_size()
                               + co * got.element_size())
                  + k * k * ci * co + 4 * ci + 8 * co)
        b_ms, by = bound_ms(flops, nbytes, peaks["int8"], peaks)
        check_bound(name, "K9", ms, b_ms)
        k9[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                        library="quantize_with + im2col + torch._int_mm + "
                                "the epilogue",
                        timing="cold, L2 flushed", launches_per_forward=count,
                        plan=plan)
        log(f"    {ms:.4f} ms (bound {b_ms:.4f}, {by}; plain {plain_ms:.3f}; "
            f"quantize + im2col + _int_mm {library_ms:.4f})")
    for (tag, xs), (x, count) in absmax_calls.items():
        name = f"{tag} {'x'.join(map(str, xs))}"
        got = qconv.absmax_nhwc(x)
        want = qconv.absmax_plain(x)
        torch.cuda.synchronize()
        log(f"  K10 {name} (x{count}): "
            f"{'bit for bit' if torch.equal(got, want) else 'DIFFERS'}")
        if not torch.equal(got, want):
            raise AssertionError(f"int8: K10 disagrees with its plain "
                                 f"version at {name}: {max_err(got, want)}")
        ms = time_cold_ms(lambda: qconv.absmax_nhwc(x), 5)
        plain_ms = time_cold_ms(lambda: qconv.absmax_plain(x), 3, warmup=1)
        library_ms = time_cold_ms(lambda: torch.linalg.vector_norm(
            x, float("inf"), dim=(0, 1, 2)), 3, warmup=1)
        numel = x.numel()
        b_ms, by = bound_ms(float(numel), numel * x.element_size()
                            + 4 * xs[3], peaks["fp32"], peaks)
        check_bound(name, "K10", ms, b_ms)
        k10[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                         library="torch.linalg.vector_norm(x, inf, dims)",
                         timing="cold, L2 flushed",
                         launches_per_forward=count)
        log(f"    {ms:.4f} ms (bound {b_ms:.4f}, {by}; plain {plain_ms:.4f}; "
            f"vector_norm {library_ms:.4f})")


QUANTIZE_OPS = ("aten::abs", "aten::amax", "aten::max", "aten::div",
                "aten::round", "aten::clamp")


def activation_quantize_ops(fn, gated) -> list:
    """The quantize ops (abs, max, divide, round, clamp) of one ``fn()``
    that take an input of the size of a gated conv's input (``gated``, the
    NHWC shapes K10 was handed in that forward; any order of the same
    sizes, so that an NCHW pass counts too): the plain PyTorch passes over
    activations that K10 and K9 replaced.  Inputs of one pixel (SISR's
    condition vectors, 20-56 values) are left out: they are the size of
    the per-channel scale vectors whose arithmetic stays PyTorch, and a
    weight's scale (1, 1, 1, Co) would match them."""
    from torch.profiler import ProfilerActivity, profile

    sizes = {tuple(sorted(g)) for g in gated if math.prod(g[:3]) > 1}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, shape, e.count)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key in QUANTIZE_OPS for shape in e.input_shapes
            if shape and tuple(sorted(shape)) in sizes]


def check_no_quantize_pass(res, key, fn, gated):
    """No plain-PyTorch quantize op over a gated conv's input in one
    ``fn()``; ``gated`` holds that forward's K10 input shapes."""
    bad = activation_quantize_ops(fn, gated)
    res[f"{key}_activation_quantize_ops"] = bad
    multi = [g for g in gated if math.prod(g[:3]) > 1]
    log(f"  quantize ops over the {len(multi)} gated input shapes of more "
        f"than one pixel in one forward (of {len(gated)}): {bad or 'none'}")
    if bad:
        raise AssertionError(f"{key}: a plain-PyTorch quantize pass over "
                             f"activations remains: {bad}")


def quantize_product_ms(r8, x) -> dict:
    """The quantize + product of one int8 forward alone: each gated conv's
    conv_w8a8 call (K10, the group reduce, the scales, the weights' fold
    and quantize, K9) recorded from one forward and replayed in order;
    device time by the profiler, ms by events (warm)."""
    from virnet_tpu_torch.models import common
    from virnet_tpu_torch.ops import qconv

    calls = []
    fn = common.conv_w8a8

    def rec(xi, kernel, bias=None, **kw):
        calls.append((xi, kernel, bias, kw))
        return fn(xi, kernel, bias, **kw)

    common.conv_w8a8 = rec
    try:
        r8.restore_batch(x)
    finally:
        common.conv_w8a8 = fn

    def replay():
        with torch.inference_mode():
            for xi, kernel, bias, kw in calls:
                qconv.conv_w8a8(xi, kernel, bias, **kw)

    prof = profile_calls(replay)
    device = sum(v[0] for v in prof["kernels"].values())
    return dict(calls=len(calls), device_ms=device,
                event_ms=time_ms(replay, 3),
                kernels={k[:60]: v for k, v in sorted(
                    prof["kernels"].items(), key=lambda kv: -kv[1][0])[:6]})


def int8_psnr(res):
    """PSNR of int8 and of bf16 against fp32, and of each against the
    clean image, on the psnr phase's image (sigma 25/255 on a smooth
    256^2 image) with the demo weights of both denoising presets."""
    from virnet_tpu_torch.eval.engine import Restorer

    clean = smooth_image(np.random.default_rng(1), 256, 256)
    noisy = (clean + np.random.default_rng(2).normal(
        0, 25 / 255, clean.shape)).astype(np.float32)
    out = {}
    for task, ckpt in (("denoising-syn", SYN_CKPT),
                       ("denoising-real", REAL_CKPT)):
        ims = {c: Restorer(task, ckpt_path=ckpt, compute=c).restore_image(
            noisy) for c in ("fp32", "bf16", "int8")}
        row = {f"{c}_vs_clean": psnr(im, clean) for c, im in ims.items()}
        row.update({f"{c}_vs_fp32": psnr(ims[c], ims["fp32"])
                    for c in ("bf16", "int8")})
        row["noisy_vs_clean"] = psnr(np.clip(noisy, 0, 1), clean)
        out[task] = row
        log(f"  psnr {task}: " + ", ".join(f"{k} {v:.2f} dB"
                                          for k, v in row.items()))
        if not row["int8_vs_clean"] > row["noisy_vs_clean"]:
            raise AssertionError(f"int8 {task}: restoration did not raise "
                                 f"the PSNR")
    res["psnr"] = out


def int8_export_round_trip(res, x):
    """A trainer checkpoint of the syn demo weights through
    cli/export_torch, load_pth and a Restorer on the card: the same
    tensors, and the same restored bits as the demo file itself; the
    state dict through to_jax_params and back, the same bits."""
    import shutil

    from virnet_tpu_torch.cli import export_torch
    from virnet_tpu_torch.convert import (from_jax_params, load_pth,
                                          to_jax_params)
    from virnet_tpu_torch.eval.engine import Restorer
    from virnet_tpu_torch.train.checkpoint import CheckpointManager

    sd = load_pth(SYN_CKPT)
    run = INT8_DIR / "run"
    shutil.rmtree(run, ignore_errors=True)
    CheckpointManager(run).save(1, dict(params=sd, epoch=1))
    path = INT8_DIR / "exported.pth"
    export_torch.main(["--task", "denoising-syn", "--run_dir", str(run),
                       "--out", str(path)])
    back = load_pth(path)
    rt = from_jax_params(to_jax_params(sd))
    same = (back.keys() == sd.keys() == rt.keys()
            and all(torch.equal(back[k], sd[k]) and torch.equal(rt[k], sd[k])
                    for k in sd))
    a = Restorer("denoising-syn", ckpt_path=path, compute="bf16")
    b = Restorer("denoising-syn", ckpt_path=SYN_CKPT, compute="bf16")
    same_out = torch.equal(a.restore_batch(x), b.restore_batch(x))
    log(f"  export -> load_pth -> Restorer: tensors "
        f"{'equal' if same else 'DIFFER'}, restored batch "
        f"{'equal' if same_out else 'DIFFERS'}")
    if not (same and same_out):
        raise AssertionError("int8: the export round trip changed weights")
    res["export_round_trip"] = dict(tensors_equal=same, outputs_equal=same_out)


def check_int8_launches(key, counts, task):
    """Exactly one K10 and one K9 per gated convolution, nothing else of
    ours."""
    want = {"absmax_nhwc": INT8_GATED[task], "conv_w8a8": INT8_GATED[task]}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"{key}: one forward launched {counts}, "
                             f"expected {want} and nothing else")


def phase_int8(report, launches, peaks, batch=32, size=256):
    """int8 (W8A8) serving on the card (see the module docstring)."""
    from virnet_tpu_torch.eval.engine import Restorer

    res: dict = {}
    report["int8"] = res
    x = torch.as_tensor(np.random.default_rng(40).random(
        (batch, size, size, 3), dtype=np.float32), device="cuda")
    calls: dict = {}
    absmax_calls: dict = {}
    path = ("conv_w8a8", "absmax_nhwc")
    for task, ckpt, tag in (("denoising-syn", SYN_CKPT, "syn"),
                            ("denoising-real", REAL_CKPT, "real")):
        log(f"[int8] {task} Restorer(compute='int8'), restore_batch "
            f"{batch}x{size}x{size}")
        r8 = Restorer(task, ckpt_path=ckpt, compute="int8")
        key = "int8" if tag == "syn" else f"int8_{tag}"
        out, launches[key] = run_path(key, lambda: r8.restore_batch(x), path)
        check_image(key, out.cpu(), (batch, size, size, 3))
        check_int8_launches(key, launches[key], task)
        shapes: dict = {}
        amax: dict = {}
        with recording_q8(shapes, amax):
            r8.restore_batch(x)
        calls.update({(tag,) + k: v for k, v in shapes.items()})
        absmax_calls.update({(tag, k): v for k, v in amax.items()})
        check_no_quantize_pass(res, key, lambda: r8.restore_batch(x), amax)
        r16 = Restorer(task, ckpt_path=ckpt, compute="bf16")
        turns = {"bf16": [], "int8": []}
        for c in ("bf16", "int8", "int8", "bf16"):
            fn = (r16 if c == "bf16" else r8).restore_batch
            turns[c].append(wall_ms(lambda: fn(x), reps=3)[0])
        res[f"{tag}_ms_per_batch"] = turns
        log(f"  ms per batch in turns (bf16, int8, int8, bf16): bf16 "
            f"{[round(v, 2) for v in turns['bf16']]}, int8 "
            f"{[round(v, 2) for v in turns['int8']]}")
        if tag == "syn":
            prof = profile_calls(lambda: r8.restore_batch(x))
            kern = prof["kernels"]
            total = sum(v[0] for v in kern.values())
            k9 = sum(v[0] for name, v in kern.items() if "q8" in name)
            k10 = sum(v[0] for name, v in kern.items() if "absmax" in name)
            top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
            res["profile"] = dict(device_ms=total, k9_ms=k9, k10_ms=k10,
                                  wall_ms=prof["wall_ms"],
                                  top=[(n, v[0], v[1]) for n, v in top],
                                  torch_ops=prof["torch_ops"][:10])
            log(f"  one int8 forward: device {total:.2f} ms, K9 {k9:.2f} "
                f"ms, K10 {k10:.2f} ms; top kernels " + "; ".join(
                    f"{n[:60]} {v[0]:.2f} ms x{v[1]}" for n, v in top[:5]))
            log("  top ops: " + "; ".join(
                f"{o[0]} {o[1]:.2f} ms x{o[2]}"
                for o in prof["torch_ops"][:6]))
            qp = quantize_product_ms(r8, x)
            res["quantize_product"] = qp
            log(f"  quantize + product of one forward ({qp['calls']} "
                f"conv_w8a8 calls replayed): device {qp['device_ms']:.2f} "
                f"ms, events {qp['event_ms']:.2f} ms")
        del r8, r16
    lr = np.random.default_rng(4).random((125, 171, 3), dtype=np.float32)
    log("[int8] sisr x4 Restorer(compute='int8'), restore_image 125x171")
    sr = Restorer("sisr", ckpt_path=SISR_CKPT, sf=4, compute="int8")
    out, launches["int8_sisr"] = run_path(
        "int8_sisr", lambda: sr.restore_image(lr), path)
    check_image("int8_sisr", out, (500, 684, 3))
    check_int8_launches("int8_sisr", launches["int8_sisr"], "sisr")
    shapes, amax = {}, {}
    with recording_q8(shapes, amax):
        sr.restore_image(lr)
    calls.update({("sisr",) + k: v for k, v in shapes.items()})
    absmax_calls.update({("sisr", k): v for k, v in amax.items()})
    check_no_quantize_pass(res, "int8_sisr", lambda: sr.restore_image(lr),
                           amax)
    prof = profile_calls(lambda: sr.restore_image(lr))
    copies = [o for o in prof["torch_ops"] if o[0] == "aten::copy_"]
    res["sisr_profile"] = dict(
        device_ms=sum(v[0] for v in prof["kernels"].values()),
        wall_ms=prof["wall_ms"], copy_=copies,
        torch_ops=prof["torch_ops"][:10])
    log(f"  one sisr int8 image: device "
        f"{res['sisr_profile']['device_ms']:.2f} ms, aten::copy_ {copies}")
    del sr
    log(f"[int8] K9 against its plain version on {len(calls)} gated "
        f"shapes, K10 on {len(absmax_calls)} inputs")
    int8_kernel_checks(calls, absmax_calls, res, peaks)
    del calls, absmax_calls
    for kern in ("conv_w8a8", "absmax_nhwc"):
        rows = [v for k, v in res[kern].items() if k.startswith("syn ")]
        res[f"syn_{kern}_ms_per_forward"] = sum(
            v["ms"] * v["launches_per_forward"] for v in rows)
        res[f"syn_{kern}_bound_ms_per_forward"] = sum(
            v["bound_ms"] * v["launches_per_forward"] for v in rows)
        log(f"  syn: {kern} {res[f'syn_{kern}_ms_per_forward']:.2f} ms per "
            f"forward cold (bound "
            f"{res[f'syn_{kern}_bound_ms_per_forward']:.2f})")
    kernels = report.setdefault("kernels", {})
    kernels["conv_w8a8"] = res["conv_w8a8"]
    kernels["absmax_nhwc"] = res["absmax_nhwc"]
    log("[int8] PSNR against fp32 and the clean image")
    int8_psnr(res)
    log("[int8] export round trip on the card")
    int8_export_round_trip(res, x[:4])


GRID_TAGS = ("Restored images", "GroundTruth", "Input")


class RecordingWriter:
    """TrainWriter's methods with a backend (``enabled``), keeping every
    scalar and image batch it is given, in place of tensorboardX (absent
    on the card's machine)."""

    enabled = True

    def __init__(self):
        self.scalars, self.images = {}, {}

    def scalar(self, tag, value, step):
        self.scalars[tag] = float(value)

    def image_grid(self, tag, batch, step, normalize=True):
        if tag in self.images:
            raise AssertionError(f"grids: {tag} written twice")
        self.images[tag] = np.array(batch)

    def close(self):
        pass


def seeded_pngs(folder, seed, n=2, size=128) -> list:
    """``n`` seeded smooth size^2 images written as PNGs."""
    import cv2

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        im = smooth_image(rng, size, size)
        paths.append(str(folder / f"val{i}.png"))
        cv2.imwrite(paths[-1], np.rint(im * 255).astype(np.uint8))
    return paths


def check_grids(name, card, cpu, tags, errs):
    """The card's image batches against the CPU's: exactly ``tags``,
    finite, in [0, 1] (grids) or each k x k summing to 1 within 1e-5
    (kernels), the restored grid and the kernel image within atol 1e-4 of
    the CPU's, the GT and input grids the same bits."""
    if sorted(card.images) != sorted(tags) or sorted(cpu.images) != sorted(
            tags):
        raise AssertionError(f"grids {name}: tags {sorted(card.images)} "
                             f"(CPU {sorted(cpu.images)}), want {tags}")
    for tag in tags:
        got, want = card.images[tag], cpu.images[tag]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"grids {name}: {tag} {got.shape} against "
                                 f"{want.shape}, or not finite")
        if tag.endswith("Kernel est|gt"):
            sums = np.abs(got.sum(axis=(1, 2, 3)) - 1.0).max()
            if got.shape[1:] != (21, 21, 1) or sums > 1e-5:
                raise AssertionError(f"grids {name}: kernels {got.shape}, "
                                     f"sums off 1 by {sums:.3g}")
        elif got.min() < 0 or got.max() > 1:
            raise AssertionError(f"grids {name}: {tag} outside [0, 1]")
        err = max_err(torch.from_numpy(got), torch.from_numpy(want))
        bar = 1e-4 if tag.endswith(("Restored images", "Kernel est|gt")) \
            else 0.0
        errs[f"{name} {tag}"] = err
        log(f"  {tag}: {tuple(got.shape)}, card vs CPU max diff {err:.3g} "
            f"(atol {bar:g})")
        if err > bar:
            raise AssertionError(f"grids {name}: {tag} disagrees with the "
                                 f"CPU by {err}")


def grid_case(name, trainer, block, tags, grids_alone, res, errs):
    """One trainer's per-epoch validation ``block(trainer, writer)`` on
    the card with the launch counters zeroed, then on a CPU twin (the
    model copied), both into RecordingWriters held by check_grids;
    ``grids_alone()`` timed after, warm.  Returns the card's launches."""
    from virnet_tpu_torch.ops import fused_conv as fc

    twin = types.SimpleNamespace(model=copy.deepcopy(trainer.model).cpu(),
                                 device=torch.device("cpu"))
    card, cpu = RecordingWriter(), RecordingWriter()
    fc.reset_launches()
    t0 = time.perf_counter()
    block(trainer, card)
    torch.cuda.synchronize()
    res[f"{name}_validate_ms"] = (time.perf_counter() - t0) * 1e3
    counts = dict(fc.LAUNCHES)
    t0 = time.perf_counter()
    block(twin, cpu)
    res[f"{name}_cpu_s"] = time.perf_counter() - t0
    check_grids(name, card, cpu, tags, errs)
    t0 = time.perf_counter()
    grids_alone()
    torch.cuda.synchronize()
    res[f"{name}_grids_ms"] = (time.perf_counter() - t0) * 1e3
    return counts


def phase_grids(report, launches):
    """The trainers' per-epoch validation with its TensorBoard image and
    kernel grids, at full width: the SISR trainer of configs/sisr_x4.json
    (train_sisr.validate_epoch on a SISRValSet of two seeded 128^2 HR
    images) and the denoising trainer of configs/denoising_syn.json
    (train_denoising_syn.validate_epoch on a DenoiseValSet of two seeded
    128^2 images), each on the card into a RecordingWriter and with the
    same weights on the CPU; then the grid calls alone, timed on the card.
    The validation forward is the trainers' conv_impl='torch' model on
    the im2col route: no kernel of the package launches."""
    import tempfile

    from virnet_tpu_torch.cli import train_denoising_syn, train_sisr
    from virnet_tpu_torch.cli.common import (eval_restore_fn,
                                             log_val_image_grids)
    from virnet_tpu_torch.data.eval_sets import DenoiseValSet
    from virnet_tpu_torch.train.logging import make_log

    t_all = time.perf_counter()
    logger = make_log(None, name="chip_smoke_grids")
    res, errs, counts = {}, {}, {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        hr_dir = Path(tmp) / "hr"
        seeded_pngs(hr_dir, 12)
        cfg = sisr_config(val_hr_path=str(hr_dir))
        t0 = time.perf_counter()
        trainer = train_sisr.build_trainer(cfg)
        res["sisr_build_s"] = time.perf_counter() - t0
        tc = trainer.cfg
        log(f"[grids] SISR: n_feat {tc.n_feat}, dep_S {tc.dep_S}, dep_K "
            f"{tc.dep_K}, sf {tc.sf}, k {tc.k_size}, val set 2 x 128^2 "
            f"HR, device {trainer.device}")
        if (tuple(tc.n_feat), tc.sf, tc.k_size) != ((96, 160, 224), 4, 21):
            raise AssertionError("grids: not the full-width configuration")
        val_sets = train_sisr.sisr_val_sets(cfg)
        val_set = val_sets["Gaussian"]

        def sisr_alone():
            log_val_image_grids(RecordingWriter(), eval_restore_fn(
                trainer.model, "cuda", sf=tc.sf),
                ((lr, hr) for hr, lr, _ in val_set), 1, tag="test_Gaussian")
            train_sisr.log_kernel_image(RecordingWriter(), trainer.model,
                                        "cuda", val_set, 1, "test_Gaussian",
                                        tc.k_size, tc.sf)

        counts["sisr"] = grid_case(
            "sisr", trainer,
            lambda t, w: train_sisr.validate_epoch(t, val_sets, cfg, 0,
                                                   logger, w),
            [f"test_{nt} {t}" for nt in val_sets
             for t in GRID_TAGS + ("Kernel est|gt",)], sisr_alone, res, errs)
        del trainer

        trainer = denoise_trainer("syn")
        tc = trainer.cfg
        log(f"[grids] denoising syn: n_feat {tc.n_feat}, dep_S {tc.dep_S}, "
            f"val set 2 x 128^2, device {trainer.device}")
        if (tuple(tc.n_feat), tc.dep_S) != ((96, 192, 288), 5):
            raise AssertionError("grids: not the full-width configuration")
        clean = DenoiseValSet(seeded_pngs(Path(tmp) / "clean", 13))
        counts["syn"] = grid_case(
            "syn", trainer,
            lambda t, w: train_denoising_syn.validate_epoch(t, clean, 0,
                                                            logger, w),
            [f"test {t}" for t in GRID_TAGS],
            lambda: log_val_image_grids(RecordingWriter(), eval_restore_fn(
                trainer.model, "cuda"), iter(clean), 1), res, errs)
        del trainer
    launches["grids"] = {k: counts["sisr"][k] + counts["syn"][k]
                         for k in counts["sisr"]}
    log(f"  launches {launches['grids']}")
    if any(launches["grids"].values()):
        raise AssertionError("grids: the validation forward is built on "
                             "plain convolutions and launches no kernel of "
                             "the package")
    res["phase_s"] = time.perf_counter() - t_all
    log(f"  SISR: validation block {res['sisr_validate_ms']:.1f} ms on the "
        f"card (2 images: scores, grids, kernel image), the grid calls "
        f"alone {res['sisr_grids_ms']:.1f} ms, the CPU's block "
        f"{res['sisr_cpu_s']:.2f} s, the trainer's build "
        f"{res['sisr_build_s']:.2f} s; denoising syn: "
        f"{res['syn_validate_ms']:.1f} ms, {res['syn_grids_ms']:.1f} ms, "
        f"{res['syn_cpu_s']:.2f} s (host clock, card synchronized); phase "
        f"{res['phase_s']:.2f} s")
    report["grids"] = dict(errs=errs, **res)


def tree_bytes(root: Path) -> dict:
    """Each file under ``root`` by relative name: its bytes, a .mat's
    past its 116-byte text header (which holds the creation time)."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            out[str(p.relative_to(root))] = (data[116:] if p.suffix == ".mat"
                                             else data)
    return out


@contextlib.contextmanager
def main_script_hidden():
    """Spawned workers of isp_process_patches without this script: spawn
    runs the parent's main file in each worker unless it has none, and
    this one imports torch (~7 s on the card's host) where the workers
    need only virnet_tpu_torch.data.isp, which imports numpy."""
    main = sys.modules["__main__"]
    path = main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        if path is not None:
            main.__file__ = path


def prepare_run(src: list, out: Path, workers: list) -> dict:
    """One run of the offline preparation into ``out``: HR crops, their
    ISP re-render in a spawned pool of 2 (``workers`` receives the number
    of processes it started), the kernel bank, camera-noise pairs and the
    corpus check; returns what each step returned and the seconds of
    each."""
    import concurrent.futures as cf

    from virnet_tpu_torch.data import isp, prepare

    class CountingPool(cf.ProcessPoolExecutor):
        def shutdown(self, *args, **kwargs):
            workers.append(len(self._processes or {}))
            super().shutdown(*args, **kwargs)

    marks = [time.perf_counter()]
    res = {"crops": prepare.crop_hr_patches(src, out / "hr")}
    marks.append(time.perf_counter())
    saved = isp.cf
    isp.cf = types.SimpleNamespace(ProcessPoolExecutor=CountingPool)
    try:
        with main_script_hidden():
            res["isp"] = isp.isp_process_patches(out / "hr", out / "isp",
                                                 max_workers=2)
    finally:
        isp.cf = saved
    marks.append(time.perf_counter())
    bank = prepare.make_kernel_bank(out / "kernels.mat")
    res["bank"] = {k: v.shape for k, v in bank.items()}
    res["bank_sums"] = max(float(np.abs(bank[f"kernels_sf{sf}"].sum(
        axis=(1, 2)) - 1).max()) for sf in (2, 3, 4))
    marks.append(time.perf_counter())
    res["pairs"] = prepare.synth_camera_pairs(src, out / "pairs")
    res["pairs"].pop("out_dir")
    res["corpus"] = prepare.verify_corpus(out / "hr", "DIV2K_train_HR")
    marks.append(time.perf_counter())
    secs = dict(zip(("crops", "isp", "bank", "pairs"), np.diff(marks)))
    return res, secs


def phase_prepare(report):
    """The offline data preparation on the card's machine (host numpy,
    cv2 and scipy): three seeded 600x600 PNGs through prepare_run twice,
    the same bytes and results both times, the layouts that
    tests/test_prepare.py and tests/test_isp.py check; the noise-benchmark
    HDF5 raises ImportError naming h5py where h5py is absent, and is read
    back through H5BenchmarkReader where it is present."""
    import tempfile

    import cv2
    from scipy.io import loadmat

    from virnet_tpu_torch.data import prepare

    t_all = time.perf_counter()
    out, workers = {}, []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(14)
        src = []
        for i in range(3):
            src.append(str(tmp / "src" / f"scene{i}.png"))
            im = smooth_image(rng, 600, 600) + rng.normal(
                0, 0.02, (600, 600, 3))
            (tmp / "src").mkdir(exist_ok=True)
            cv2.imwrite(src[-1], np.clip(np.rint(im * 255), 0, 255).astype(
                np.uint8))
        runs, trees, secs = [], [], []
        for k in range(2):
            res, step_s = prepare_run(src, tmp / f"run{k}", workers)
            runs.append(res)
            secs.append(step_s)
            trees.append(tree_bytes(tmp / f"run{k}"))
        log(f"[prepare] two runs: {len(trees[0])} files each; ISP pool "
            f"processes {workers}; seconds "
            + "; ".join(", ".join(f"{k} {v:.2f}" for k, v in s.items())
                        for s in secs))
        if runs[0] != runs[1] or trees[0] != trees[1]:
            differ = [n for n in trees[0] if trees[0][n] != trees[1].get(n)]
            raise AssertionError(f"prepare: the two runs differ: "
                                 f"{differ[:5]}, {runs}")
        if not all(workers):
            raise AssertionError("prepare: the ISP pool started no process")
        res, root = runs[0], tmp / "run0"
        crops = sorted((root / "hr").glob("*.png"))
        metas = sorted((root / "isp" / "meta").glob("*.json"))
        isp_ims = sorted((root / "isp" / "images").glob("*.png"))
        meta = json.loads(metas[0].read_text())
        pairs = res["pairs"]
        noisy = sorted((root / "pairs" / "patches256" / "noisy").glob("*"))
        gt = sorted((root / "pairs" / "patches256" / "gt").glob("*"))
        vn = loadmat(root / "pairs" / "ValidationNoisyBlocksSrgb.mat")[
            "ValidationNoisyBlocksSrgb"]
        bank = loadmat(root / "kernels.mat")
        checks = {
            "12 crops of 512^2": res["crops"] == len(crops) == 12
            and cv2.imread(str(crops[0])).shape == (512, 512, 3),
            "an image and a config per patch": res["isp"] == len(isp_ims)
            == len(metas) == 12 and set(meta) >= {"wb_gains", "ccm",
                                                  "tone_m", "tone_s"},
            "ISP images 512^2 uint8":
            cv2.imread(str(isp_ims[0])).shape == (512, 512, 3),
            "7 kernels of 21^2 per sf, sums 1 within 1e-5":
            all(bank[f"kernels_sf{sf}"].shape == (7, 21, 21)
                for sf in (2, 3, 4)) and res["bank_sums"] <= 1e-5,
            "camera pairs": pairs["n_train"] == len(noisy) == len(gt) == 24
            and pairs["val_shape"] == (1, 4, 256, 256, 3)
            and vn.shape == (1, 4, 256, 256, 3) and vn.dtype == np.uint8,
            "verify_corpus": res["corpus"] == dict(
                name="DIV2K_train_HR", found=12, expected=800, ok=False),
        }
        for what, ok in checks.items():
            log(f"  {what}: {'ok' if ok else 'FAILED'}")
        if not all(checks.values()):
            raise AssertionError(f"prepare: layout checks failed: {checks}")
        try:
            import h5py  # noqa: F401
        except ImportError:
            h5_case = "h5py absent"
        else:
            h5_case = "h5py present"
        if h5_case == "h5py absent":
            try:
                prepare.write_noise_benchmark_h5(tmp / "src", tmp / "h5")
            except ImportError as exc:
                if "h5py" not in str(exc):
                    raise AssertionError(f"prepare: the ImportError does "
                                         f"not name h5py: {exc}")
                log(f"  write_noise_benchmark_h5 without h5py: "
                    f"ImportError: {exc}")
            else:
                raise AssertionError("prepare: write_noise_benchmark_h5 "
                                     "ran without h5py")
        else:
            from virnet_tpu_torch.data.h5_bench import H5BenchmarkReader

            files = prepare.write_noise_benchmark_h5(tmp / "src", tmp / "h5")
            for f in files:
                with H5BenchmarkReader(f) as r:
                    rows = list(r)
                if [x[0] for x in rows] != ["scene0", "scene1", "scene2"] \
                        or any(x[1].shape != (600, 600, 3)
                               or x[3].shape != (600, 600)
                               or not np.isfinite(x[1]).all() for x in rows):
                    raise AssertionError(f"prepare: {f} reads back wrong")
            log(f"  write_noise_benchmark_h5: {len(files)} files read back "
                f"through H5BenchmarkReader")
    secs_all = time.perf_counter() - t_all
    log(f"  prepare phase {secs_all:.2f} s ({h5_case})")
    report["prepare"] = dict(run_s=secs, total_s=secs_all, h5=h5_case,
                             isp_processes=workers, files=len(trees[0]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the full results as JSON here")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of another tree (the parent commit): "
                         "phase blur times its csrc/blur.cu beside this "
                         "one's in turns")
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
    report["launch_us"] = {"start": launch_us()}
    log(f"host cost of one tiny launch at the start: "
        f"{report['launch_us']['start']:.2f} us")

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

    if "kernels" in phases or "resblock" in phases:
        phase_resblock(report, peaks)

    if "blur" in phases:
        phase_blur(report, peaks, args.parent)

    launches: dict = {}       # path -> the counts of its one run
    rng = np.random.default_rng(0)

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
        syn = Restorer("denoising-syn", ckpt_path=SYN_CKPT, compute="bf16")
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

    if "serve_sisr" in phases:
        phase_serve_sisr(report, launches)

    if "train_fp32" in phases:
        log("[train_fp32] one SISR training step at 2x96^2, card vs CPU")
        phase_train_fp32(report)

    if "train_sisr" in phases:
        phase_train_sisr(report, launches)

    if "train_pipeline" in phases:
        phase_train_pipeline(report, launches)

    if "train_denoise_fp32" in phases:
        log("[train_denoise_fp32] one denoising training step at 2x64^2, "
            "syn and real, card vs CPU")
        phase_train_denoise_fp32(report)

    if "train_denoise" in phases:
        phase_train_denoise(report, launches)

    if "eval_tables" in phases:
        phase_eval_tables(report, launches)

    if "runtime" in phases:
        phase_runtime(report, launches)

    if "int8" in phases:
        phase_int8(report, launches, peaks)

    if "grids" in phases:
        phase_grids(report, launches)

    if "prepare" in phases:
        phase_prepare(report)

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
