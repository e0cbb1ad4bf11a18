"""Offline dataset preparation (counterpart of virnet_tpu/data/prepare.py;
reference datasets/prepare_data/*).

* SIDD patch cropper: random 256^2 patch pairs per scene, in threads
  (reference .../SIDD/im2patch_train.py:45-82)
* SISR HR patch cropper: strided 512^2 crops of DIV2K/Flickr2K
  (reference .../SISR/im2patch_train.py:33-54)
* kernel bank: the 7 eval kernels per sf into a .mat
  (reference .../SISR/make_kernel_noise.py:19-32)
* synthetic-noise HDF5 writer: noisy/gt/sigma per benchmark case
  (reference .../simulation/noise_generate.py:30-73)
* download work-lists for SIDD and the training corpora: lines for any
  fetcher; nothing here fetches
* camera-noise pair synthesizer: a SIDD-style paired dataset (train folder
  pair + validation .mats) from clean images, for offline demo training
* ISP re-rendering of HR patches is ``data/isp.py``
  (``isp_process_patches``; reference .../SISR/prepare_patch_isp.py)

Host numpy and cv2; scipy, cv2 and h5py are imported by the functions that
use them, so the package imports without them.
"""

from __future__ import annotations

import concurrent.futures as cf
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..ops.color import imread, imwrite
from ..ops.sigma_fields import (gauss_kernel_mix, peaks, rescale_field,
                                sincos_kernel)


def crop_sidd_patches(noisy_gt_pairs: Sequence, out_dir,
                      pch_size: int = 256, num_patch_per_img: int = 400,
                      prefix: str = "sidd_", seed: int = 10000,
                      max_workers: int = 8) -> int:
    """Random patch pairs from full-size SIDD scenes into
    <out>/noisy/<prefix>N.png + <out>/gt/<prefix>N.png; scene ``idx``
    draws from the seed ``seed + idx``.  Returns the number of pairs."""
    out_dir = Path(out_dir)
    (out_dir / "noisy").mkdir(parents=True, exist_ok=True)
    (out_dir / "gt").mkdir(parents=True, exist_ok=True)

    def process(job):
        idx, (noisy_path, gt_path) = job
        rng = np.random.default_rng(seed + idx)
        im_noisy = imread(noisy_path, chn="bgr", dtype="uint8")
        im_gt = imread(gt_path, chn="bgr", dtype="uint8")
        h, w = im_noisy.shape[:2]
        count = 0
        for jj in range(num_patch_per_img):
            i0 = int(rng.integers(0, h - pch_size + 1))
            j0 = int(rng.integers(0, w - pch_size + 1))
            name = f"{prefix}{idx * num_patch_per_img + jj}.png"
            imwrite(im_noisy[i0:i0 + pch_size, j0:j0 + pch_size],
                    out_dir / "noisy" / name, chn="bgr")
            imwrite(im_gt[i0:i0 + pch_size, j0:j0 + pch_size],
                    out_dir / "gt" / name, chn="bgr")
            count += 1
        return count

    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        counts = list(ex.map(process, enumerate(noisy_gt_pairs)))
    return sum(counts)


def crop_hr_patches(im_paths: Sequence[str], out_dir, pch_size: int = 512,
                    stride: int = 320, max_workers: int = 8) -> int:
    """Strided HR crops for SISR training (DIV2K + Flickr2K style), named
    <stem>_pNNN.png; the last row and column of crops end at the border.
    Returns the number of crops."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def process(job):
        idx, path = job
        im = imread(path, chn="bgr", dtype="uint8")
        h, w = im.shape[:2]
        count = 0
        ind_h = list(range(0, h - pch_size, stride)) + [h - pch_size]
        ind_w = list(range(0, w - pch_size, stride)) + [w - pch_size]
        for i0 in ind_h:
            for j0 in ind_w:
                name = f"{Path(path).stem}_p{count:03d}.png"
                imwrite(im[i0:i0 + pch_size, j0:j0 + pch_size],
                        out_dir / name, chn="bgr")
                count += 1
        return count

    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        counts = list(ex.map(process, enumerate(im_paths)))
    return sum(counts)


def make_kernel_bank(out_path, sfs: Sequence[int] = (2, 3, 4),
                     k_size: int = 21, shift: bool = False) -> dict:
    """The 7 Table-5 eval kernels per scale factor as a bank
    {'kernels_sf2': (7, k, k), 'kinfos_sf2': (7, 3), ...}, written to the
    .mat ``out_path`` unless it is None."""
    import scipy.io as sio

    from .eval_sets import table5_kernels

    bank = {}
    for sf in sfs:
        kernels = np.stack([k for k, _ in table5_kernels(sf, k_size, shift)])
        kinfos = np.stack([ki for _, ki in table5_kernels(sf, k_size, shift)])
        bank[f"kernels_sf{sf}"] = kernels
        bank[f"kinfos_sf{sf}"] = kinfos
    if out_path is not None:
        sio.savemat(str(out_path), bank)
    return bank


def write_noise_benchmark_h5(im_dir, out_dir, exts: Sequence[str] = ("png",),
                             seed: int = 1000) -> List[str]:
    """Write noisy/gt/sigma-map HDF5 files for every benchmark case: the
    three niid fields and iid sigma in {15, 25, 50}.  Returns the paths.
    Raises ImportError where h5py is not installed."""
    import cv2
    import h5py

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    im_paths = sorted(p for ext in exts
                      for p in Path(im_dir).glob(f"*.{ext}"))

    rng = np.random.default_rng(seed)
    cases = {
        "peaks": rescale_field(peaks(256), 10 / 255, 75 / 255),
        "sincos": rescale_field(sincos_kernel(), 10 / 255, 75 / 255),
        "gauss_mix": rescale_field(gauss_kernel_mix(256, 256, rng),
                                   10 / 255, 75 / 255),
        "iid15": 15, "iid25": 25, "iid50": 50,
    }
    written = []
    for case, base in cases.items():
        out_path = out_dir / f"benchmark_{case}.hdf5"
        with h5py.File(out_path, "w") as f:
            for p in im_paths:
                im_gt = imread(p, chn="rgb", dtype="float32")
                h, w = im_gt.shape[:2]
                if isinstance(base, (int, float)):
                    sigma = np.full((h, w), base / 255.0, dtype=np.float32)
                else:
                    sigma = cv2.resize(
                        base, (w, h),
                        interpolation=cv2.INTER_NEAREST_EXACT)
                noise = rng.standard_normal(
                    size=im_gt.shape).astype(np.float32)
                im_noisy = im_gt + noise * sigma[:, :, None]
                g = f.create_group(Path(p).stem)
                g.create_dataset("gt", data=im_gt)
                g.create_dataset("noisy", data=im_noisy)
                g.create_dataset("sigma", data=sigma)
        written.append(str(out_path))
    return written


SIDD_BASE_URL = ("https://competitions.codalab.org/my/datasets/download/")


def sidd_download_list(cameras: Optional[Sequence[str]] = None,
                       srgb_only: bool = True,
                       urls_file: Optional[str] = None) -> List[str]:
    """Download work-list for SIDD.

    With ``urls_file`` (the official ``SIDD_URLs.txt`` that the
    reference's downloader reads), the reference's filter: ``camera in url
    and 'SRGB' in url``, the file name being the URL's last path component
    (.../SIDD/download_sidd_all.py:11-23); returns ``"<camera>/<filename>
    <url>"`` lines for any fetcher.  Without it, the SIDD_Medium
    per-camera part archive names of the official distribution."""
    cameras = cameras or ["GP", "IP", "S6", "N6", "G4"]
    if urls_file is not None:
        lines: List[str] = []
        with open(urls_file) as f:
            urls = [u.rstrip("\n") for u in f]
        kind = "SRGB" if srgb_only else "RAW"
        for camera in cameras:
            for url in urls:
                if camera in url and kind in url:
                    lines.append(f"{camera}/{url.split('/')[-1]} {url}")
        return lines
    return [(f"SIDD_Medium_Srgb_Parts_{cam}.zip" if srgb_only
             else f"SIDD_Medium_Raw_Parts_{cam}.zip") for cam in cameras]


# ------------------------------------------------------------------ corpora

#: The reference's training corpora (configs/denoising_syn.json:27-31 names
#: the four denoising folders; the SISR HR pool is DIV2K+Flickr2K,
#: datasets/prepare_data/SISR/im2patch_train.py:33-54): for each, the
#: official distribution URL(s), the path inside the archive that holds
#: the images, and the image count of the folder the configs point at;
#: enough to fetch, unpack and verify on a machine with network access.
TRAIN_CORPORA = {
    "CBSD432": dict(
        urls=["https://www2.eecs.berkeley.edu/Research/Projects/CS/"
              "vision/grouping/BSR/BSR_bsds500.tgz"],
        inner_path="BSR/BSDS500/data/images/{train,val}",
        expected_images=432, ext="jpg",
        note="CBSD432 = the 432 color train+val images of BSDS500 "
             "(the 68 test images are the CBSD68 eval set and must be "
             "excluded from training)"),
    "WED": dict(
        urls=["https://ivc.uwaterloo.ca/database/WaterlooExploration/"
              "exploration_database_and_code.rar"],
        inner_path="pristine_images",
        expected_images=4744, ext="bmp",
        note="Waterloo Exploration Database"),
    "Flickr2K_HR": dict(
        urls=["https://cv.snu.ac.kr/research/EDSR/Flickr2K.tar"],
        inner_path="Flickr2K/Flickr2K_HR",
        expected_images=2650, ext="png", note="Flickr2K HR images"),
    "DIV2K_train_HR": dict(
        urls=["https://data.vision.ee.ethz.ch/cvl/DIV2K/"
              "DIV2K_train_HR.zip"],
        inner_path="DIV2K_train_HR",
        expected_images=800, ext="png",
        note="DIV2K training HR (NTIRE 2017)"),
}


def corpus_download_list(names: Optional[Sequence[str]] = None) -> List[str]:
    """Download work-list for the training corpora, one line per archive:
    ``<corpus>/<filename> <url>``, the line format of
    ``sidd_download_list``.  ``names`` defaults to all four corpora."""
    names = list(names) if names is not None else list(TRAIN_CORPORA)
    lines: List[str] = []
    for name in names:
        spec = TRAIN_CORPORA[name]
        for url in spec["urls"]:
            lines.append(f"{name}/{url.split('/')[-1]} {url}")
    return lines


def synth_camera_pairs(im_paths: Sequence, out_dir, pch_size: int = 256,
                       patches_per_img: int = 12, seed: int = 20260817,
                       n_val_imgs: int = 8, n_val_blocks: int = 4,
                       shot_range=(2e-4, 8e-3),
                       read_range=(1e-6, 1e-4)) -> dict:
    """Synthesize a SIDD-style paired real-noise dataset from clean images.

    The reference's real-noise trainer reads SIDD scene pairs
    (datasets/DenoisingDatasets.py:101-177).  This stands in for them:
    each source image becomes a "scene" with one camera-noise draw,
    heteroscedastic Gaussian noise with var = a*I + b on the sRGB
    intensity (a, b log-uniform per scene), quantized to uint8.  The
    signal-dependent variance exercises the trainer's sigma^2-prior
    residual filter (ops/degrade.py:noise_estimate) as SIDD data does.
    Gray sources become three equal channels; an alpha channel is dropped.

    Writes the layout configs/denoising_real.json expects:
      <out>/patches256/{noisy,gt}/cam_N.png        (training pairs)
      <out>/ValidationNoisyBlocksSrgb.mat          (n_val_imgs, n_val_blocks,
      <out>/ValidationGtBlocksSrgb.mat              pch, pch, 3) uint8
    Returns {'n_train', 'val_shape', 'out_dir'}.
    """
    from scipy.io import savemat

    out_dir = Path(out_dir)
    noisy_dir = out_dir / "patches256" / "noisy"
    gt_dir = out_dir / "patches256" / "gt"
    noisy_dir.mkdir(parents=True, exist_ok=True)
    gt_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)

    def camera_noise(img_f32):
        lo, hi = shot_range
        a = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        lo, hi = read_range
        b = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        sig = np.sqrt(a * np.clip(img_f32, 0.0, 1.0) + b).astype(np.float32)
        noisy = img_f32 + rng.standard_normal(img_f32.shape).astype(
            np.float32) * sig
        return np.clip(np.round(noisy * 255.0), 0, 255).astype(np.uint8)

    im_paths = sorted(str(p) for p in im_paths)
    n_train = 0
    val_noisy, val_gt = [], []
    for idx, path in enumerate(im_paths):
        gt_u8 = imread(path, chn="bgr", dtype="uint8")
        if gt_u8.ndim == 2:          # grayscale source -> 3-channel scene
            gt_u8 = np.stack([gt_u8] * 3, axis=2)
        elif gt_u8.shape[2] == 4:    # drop alpha: the layout is (..., 3)
            gt_u8 = gt_u8[:, :, :3]
        h, w = gt_u8.shape[:2]
        if h < pch_size or w < pch_size:
            continue
        noisy_u8 = camera_noise(gt_u8.astype(np.float32) / 255.0)
        is_val = len(val_noisy) < n_val_imgs and idx % 5 == 0
        if is_val:
            blocks_n, blocks_g = [], []
            for _ in range(n_val_blocks):
                i0 = int(rng.integers(0, h - pch_size + 1))
                j0 = int(rng.integers(0, w - pch_size + 1))
                sl = np.s_[i0:i0 + pch_size, j0:j0 + pch_size]
                blocks_n.append(noisy_u8[sl][:, :, ::-1])  # BGR->RGB
                blocks_g.append(gt_u8[sl][:, :, ::-1])
            val_noisy.append(np.stack(blocks_n))
            val_gt.append(np.stack(blocks_g))
        else:
            for _ in range(patches_per_img):
                i0 = int(rng.integers(0, h - pch_size + 1))
                j0 = int(rng.integers(0, w - pch_size + 1))
                sl = np.s_[i0:i0 + pch_size, j0:j0 + pch_size]
                name = f"cam_{n_train}.png"
                imwrite(noisy_u8[sl], noisy_dir / name, chn="bgr")
                imwrite(gt_u8[sl], gt_dir / name, chn="bgr")
                n_train += 1

    val_noisy_arr = np.stack(val_noisy) if val_noisy else np.zeros(
        (0, n_val_blocks, pch_size, pch_size, 3), np.uint8)
    val_gt_arr = np.stack(val_gt) if val_gt else val_noisy_arr
    savemat(out_dir / "ValidationNoisyBlocksSrgb.mat",
            {"ValidationNoisyBlocksSrgb": val_noisy_arr})
    savemat(out_dir / "ValidationGtBlocksSrgb.mat",
            {"ValidationGtBlocksSrgb": val_gt_arr})
    return dict(n_train=n_train, val_shape=tuple(val_noisy_arr.shape),
                out_dir=str(out_dir))


def verify_corpus(root, name: str) -> dict:
    """Check an unpacked corpus folder against the expected inventory.

    Returns {'name', 'found', 'expected', 'ok'}; ``found`` counts
    ``*.<ext>`` files at any depth under ``root`` (the configs glob a flat
    folder, but archives unpack nested)."""
    spec = TRAIN_CORPORA[name]
    found = len(list(Path(root).rglob(f"*.{spec['ext']}")))
    return dict(name=name, found=found, expected=spec["expected_images"],
                ok=found == spec["expected_images"])
