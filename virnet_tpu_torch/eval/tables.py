"""Benchmark-table harnesses (counterpart of virnet_tpu/eval/tables.py;
reference scripts/, SURVEY.md section 2.6).

Table 1/2 — synthetic denoising (niid/iid) on CBSD68 + McMaster
Table 4   — real denoising on SIDD validation blocks (+ megatime)
Table 5   — blind SISR on Set14 + CBSD68, 7 fixed kernels

Scoring is the MATLAB-faithful protocol of eval/metrics.py (uint8 round
trip, border, Y channel) or, for SIDD on request, eval/metrics_device.py.
Each table has a core that takes images in memory — (name, uint8 HWC)
lists per set, or the SIDD block arrays — and the JAX package's signature,
which reads folders or ``.mat`` files, over it: reading images needs cv2,
the cores do not.

Table 1/2's noise synthesis stays sequential on one RNG stream (the
reference's noise, bit for bit); Table 5's degradations each seed their
own.  Forwards are batched per image shape.  The JAX harness pads
remainder batches by repeating the last image to save XLA recompiles;
eager PyTorch compiles nothing, so the port does not, and per-image
scores do not change.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.eval_sets import DenoiseBenchmark, table5_kernels
from ..ops.color import imread
from ..ops.degrade import degrade_np
from ..ops.pad import modcrop
from ..ops.quant import img_as_float32, img_as_ubyte
from . import lpips as lpips_mod
from .engine import Restorer
from .metrics import calculate_psnr, calculate_ssim
from .tta import tta_x8

ImageSet = List[Tuple[str, np.ndarray]]


def read_set(d) -> ImageSet:
    """(stem, uint8 RGB HWC) of the images of a folder (``*.png``) or a
    glob such as ``dir/*.tif``, sorted by path."""
    d = str(d)
    pattern = Path(d).name if "*" in d else "*.png"
    root = Path(d).parent if "*" in d else Path(d)
    return [(p.stem, imread(p, chn="rgb", dtype="uint8"))
            for p in sorted(root.glob(pattern), key=str)]


def _restore_grouped(restorer: Restorer, ims: List[np.ndarray],
                     batch_size: int) -> List[np.ndarray]:
    """Restore HWC float32 images in batches of the same shape (each padded
    to the restorer's bucket and cropped back); outputs in input order."""
    outs: list = [None] * len(ims)
    groups: Dict[tuple, list] = {}
    for i, im in enumerate(ims):
        groups.setdefault(im.shape, []).append(i)
    for idx in groups.values():
        for s in range(0, len(idx), batch_size):
            sub = idx[s:s + batch_size]
            y = restorer._restore_padded(np.stack([ims[i] for i in sub]))
            for i, o in zip(sub, y):
                outs[i] = o
    return outs


def denoise_synthetic_table(restorer: Restorer, sets: Dict[str, ImageSet],
                            noise_type: str = "niid", seed: int = 1000,
                            batch_size: int = 8,
                            log_fn=print) -> Dict[str, Dict[str, Dict]]:
    """Table 1/2 (reference scripts/denoising_virnet_syn.py) on images in
    memory: ``sets`` maps a dataset name to its (name, uint8 RGB HWC) list.
    Returns results[dataset][case] = {'psnr', 'ssim', per-image scores,
    'seconds' (the case's synthesis, forwards and scoring)}."""
    bench = DenoiseBenchmark(noise_type, seed)
    results: Dict[str, Dict] = {}
    for data_name, images in sets.items():
        results[data_name] = {}
        for case_name, base in bench.cases():
            tic = time.perf_counter()
            noisy = [bench.noisy(im, base) for _, im in images]
            outs = _restore_grouped(restorer, noisy, batch_size)
            psnrs, ssims = {}, {}
            for (name, im_gt), o in zip(images, outs):
                im_dn = img_as_ubyte(np.clip(o, 0.0, 1.0))
                psnrs[name] = calculate_psnr(im_dn, im_gt, border=0)
                ssims[name] = calculate_ssim(im_dn, im_gt, border=0)
            mean_psnr = float(np.mean(list(psnrs.values())))
            mean_ssim = float(np.mean(list(ssims.values())))
            log_fn(f"Dataset: {data_name:>9s}, Case: {case_name}, "
                   f"PSNR: {mean_psnr:5.2f}, SSIM: {mean_ssim:6.4f}")
            results[data_name][str(case_name)] = dict(
                psnr=mean_psnr, ssim=mean_ssim, psnr_per_image=psnrs,
                ssim_per_image=ssims, seconds=time.perf_counter() - tic)
    return results


def eval_denoise_synthetic(restorer: Restorer, data_dirs: Dict[str, str],
                           noise_type: str = "niid", seed: int = 1000,
                           batch_size: int = 8,
                           log_fn=print) -> Dict[str, Dict[str, Dict]]:
    """Table 1/2 on folders: data_dirs {'CBSD68': path, 'McMaster': path}
    (a folder of PNGs or a glob like 'dir/*.tif')."""
    return denoise_synthetic_table(
        restorer, {k: read_set(d) for k, d in data_dirs.items()},
        noise_type, seed, batch_size, log_fn)


def sidd_table(restorer: Restorer, noisy: np.ndarray,
               gt: Optional[np.ndarray] = None, flip_tta: bool = True,
               batch: int = 16, device_metrics: bool = False,
               log_fn=print) -> Dict:
    """Table 4 (reference scripts/denoising_virnet_real_sidd.py:98-164) on
    uint8 block arrays (n, h, w, c): ``batch`` blocks at a time, with the
    x8 ensemble (``flip_tta``) as one forward of 8 x batch blocks, the
    uint8 round trip, and per-block PSNR/SSIM against ``gt`` when given
    (host scorers, or eval/metrics_device.py with ``device_metrics``).
    Megatime is seconds per restored 1024^2 megapixel, forward time only
    (the first forward's warm-up included, as in the reference): the input
    is on the device before the clock starts and the clock stops once the
    output is on the host, as in the JAX harness.  Returns psnr, ssim (means; None without gt),
    psnr_per_block, ssim_per_block, megatime, blocks (uint8 (n, h, w, c))
    and forward_seconds (one per forward call)."""
    from .metrics_device import batch_psnr_device, batch_ssim_device

    n_blocks, h, w, _ = noisy.shape
    device = restorer.device
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    blocks = np.empty_like(noisy)
    psnrs = np.zeros(n_blocks)
    ssims = np.zeros(n_blocks)
    forward_seconds = []
    for k, start in enumerate(range(0, n_blocks, batch)):
        end = min(start + batch, n_blocks)
        x = torch.from_numpy(img_as_float32(noisy[start:end])).to(device)
        sync()
        tic = time.perf_counter()
        out = (tta_x8(restorer.restore_batch, x) if flip_tta
               else restorer.restore_batch(x))
        out = out.cpu().numpy()     # the host fetch is the sync
        forward_seconds.append(time.perf_counter() - tic)
        out_u8 = img_as_ubyte(np.clip(out, 0.0, 1.0))
        blocks[start:end] = out_u8
        if gt is not None and device_metrics:
            gt_f = torch.from_numpy(img_as_float32(gt[start:end])).to(device)
            out_f = torch.from_numpy(img_as_float32(out_u8)).to(device)
            psnrs[start:end] = batch_psnr_device(out_f, gt_f).cpu().numpy()
            ssims[start:end] = batch_ssim_device(out_f, gt_f).cpu().numpy()
        elif gt is not None:
            for i in range(start, end):
                psnrs[i] = calculate_psnr(gt[i], blocks[i])
                ssims[i] = calculate_ssim(gt[i], blocks[i])
        if k % 10 == 0:
            log_fn(f"{end}/{n_blocks} blocks")
    scored = gt is not None
    return dict(psnr=float(psnrs.mean()) if scored else None,
                ssim=float(ssims.mean()) if scored else None,
                psnr_per_block=psnrs if scored else None,
                ssim_per_block=ssims if scored else None,
                megatime=sum(forward_seconds) * 1024 ** 2 / (n_blocks * h * w),
                blocks=blocks, forward_seconds=forward_seconds)


def load_sidd_blocks(mat_path, key: str) -> np.ndarray:
    """The (images, blocks, h, w, c) uint8 array of a SIDD ``.mat``."""
    from scipy.io import loadmat

    return loadmat(str(mat_path))[key]


def eval_sidd(restorer: Restorer, noisy_mat: str, gt_mat: str,
              flip_tta: bool = True, log_fn=print) -> Dict:
    """Table 4 on the validation ``.mat`` pair: 1280 blocks of 256^2,
    batches of 16; returns psnr, ssim, megatime and the denoised blocks
    (flat, (n, h, w, c))."""
    noisy = load_sidd_blocks(noisy_mat, "ValidationNoisyBlocksSrgb")
    gt = load_sidd_blocks(gt_mat, "ValidationGtBlocksSrgb")
    shape = noisy.shape[2:]
    res = sidd_table(restorer, noisy.reshape(-1, *shape),
                     gt.reshape(-1, *shape), flip_tta, log_fn=lambda m: None)
    log_fn(f"SIDD: PSNR={res['psnr']:5.2f}, SSIM={res['ssim']:6.4f}, "
           f"megatime={res['megatime']:.4f} s/MP "
           f"(tta={'x8' if flip_tta else 'off'})")
    return {k: res[k] for k in ("psnr", "ssim", "megatime", "blocks")}


def sisr_synthetic_table(restorer: Restorer, sets: Dict[str, ImageSet],
                         sf: int, nlevel: float = 2.55,
                         qf: Optional[int] = None, seed: int = 1234,
                         downsampler: str = "bicubic", use_lpips=None,
                         batch_size: int = 8,
                         log_fn=print) -> Dict[str, Dict]:
    """Table 5 (reference scripts/sisr_virnet_syn.py:98-193) on images in
    memory: each HR image modcropped (gray stacked to RGB), degraded by the
    7 fixed kernels with seeded noise (host ``degrade_np``, the images of
    a kernel on threads), restored in
    batches per LR shape, scored on the Y channel with border sf^2, and by
    LPIPS-alex on RGB on the restorer's device when weights are available
    (``use_lpips=None`` -> auto; the reason is recorded when skipped).
    Each kernel's record has 'seconds' (its synthesis, forwards and
    scoring)."""
    if use_lpips is None:
        use_lpips = lpips_mod.available()
    if not use_lpips:
        log_fn(f"LPIPS: {lpips_mod.skip_reason()}")
    results: Dict[str, Dict] = {}
    kernels = table5_kernels(sf)
    for data_name, images in sets.items():
        gts = []
        for name, im in images:
            im = modcrop(im, sf)
            gts.append((name, np.stack([im] * 3, axis=2)
                        if im.ndim == 2 else im))
        per_kernel = []
        for ind_k, (kernel, _kinfo) in enumerate(kernels):
            tic = time.perf_counter()
            # each degradation seeds its own RNG, so threads give the same
            # pixels in any order; scipy's blur releases the GIL
            with ThreadPoolExecutor() as pool:
                lrs = list(pool.map(
                    lambda g: degrade_np(img_as_float32(g[1]), kernel, sf,
                                         nlevel=nlevel, qf=qf, seed=seed,
                                         downsampler=downsampler), gts))
            outs = _restore_grouped(restorer, lrs, batch_size)
            psnrs, ssims, lpipss = {}, {}, {}
            for (name, im_gt), o in zip(gts, outs):
                im_sr = img_as_ubyte(np.clip(o, 0.0, 1.0))
                psnrs[name] = calculate_psnr(im_sr, im_gt, sf ** 2, True)
                ssims[name] = calculate_ssim(im_sr, im_gt, sf ** 2, True)
                if use_lpips:
                    lpipss[name] = lpips_mod.lpips_rgb(im_sr, im_gt,
                                                       restorer.device)
            mp, ms = (float(np.mean(list(psnrs.values()))),
                      float(np.mean(list(ssims.values()))))
            rec = dict(psnr=mp, ssim=ms, psnr_per_image=psnrs,
                       ssim_per_image=ssims)
            msg = (f"Dataset: {data_name:>8s}, Kernel: {ind_k + 1}, "
                   f"PSNRY: {mp:5.2f}, SSIMY: {ms:6.4f}")
            if use_lpips:
                rec["lpips"] = float(np.mean(list(lpipss.values())))
                msg += f", LPIPS: {rec['lpips']:6.4f}"
            else:
                rec["lpips"] = lpips_mod.skip_reason()
            rec["seconds"] = time.perf_counter() - tic
            per_kernel.append(rec)
            log_fn(msg)
        results[data_name] = dict(
            per_kernel=per_kernel,
            psnr=float(np.mean([k["psnr"] for k in per_kernel])),
            ssim=float(np.mean([k["ssim"] for k in per_kernel])))
        msg = (f"Dataset: {data_name:>8s}, "
               f"PSNRY: {results[data_name]['psnr']:5.2f}, "
               f"SSIMY: {results[data_name]['ssim']:6.4f}")
        if use_lpips:
            results[data_name]["lpips"] = float(
                np.mean([k["lpips"] for k in per_kernel]))
            msg += f", LPIPS: {results[data_name]['lpips']:6.4f}"
        else:
            results[data_name]["lpips"] = lpips_mod.skip_reason()
        log_fn(msg)
    return results


def eval_sisr_synthetic(restorer: Restorer, data_dirs: Dict[str, str],
                        sf: int, nlevel: float = 2.55,
                        qf: Optional[int] = None, seed: int = 1234,
                        downsampler: str = "bicubic", use_lpips=None,
                        batch_size: int = 8, log_fn=print) -> Dict[str, Dict]:
    """Table 5 on folders or globs (see ``read_set``)."""
    return sisr_synthetic_table(
        restorer, {k: read_set(d) for k, d in data_dirs.items()}, sf,
        nlevel, qf, seed, downsampler, use_lpips, batch_size, log_fn)
