"""DND benchmark harness: the official crop loop and the submission bundler
(counterpart of virnet_tpu/eval/dnd.py).

The vendored Plötz/Roth kit the reference ships
(dnd_submission_py/dnd_denoise.py:78-123, bundle_submissions.py:45-73): 50
sRGB images x 20 bounding boxes from info.mat, each crop denoised and saved
as %04d_%02d.mat, then bundled into per-image object arrays for upload.
The denoiser is a Restorer's batch forward on its device, with the x8
flip ensemble as one batched forward (eval/tta.py).  The loops are numpy,
scipy and h5py, imported where they are used (h5py is not installed on the
card's machine).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .engine import Restorer
from .tta import tta_x8


def make_denoiser(restorer: Restorer, flip: bool = True):
    """Wrap a Restorer's NHWC batch forward into the (Inoisy, nlf) ->
    denoised interface of the DND loop (reference
    dnd_submission_py/pytorch_wrapper.py:15-49): the crop goes to the
    restorer's device, through the x8 ensemble (``flip``; crops are
    square) or one forward, and back as float32 HWC."""
    restore_batch = restorer.restore_batch

    def denoiser(inoisy: np.ndarray, nlf=None) -> np.ndarray:
        x = torch.as_tensor(np.ascontiguousarray(inoisy[None]),
                            dtype=torch.float32).to(restorer.device)
        out = tta_x8(restore_batch, x) if flip else restore_batch(x)
        return out[0].float().cpu().numpy()

    return denoiser


def denoise_srgb(denoiser: Callable, data_folder, out_folder,
                 log_fn=print) -> None:
    """Run the official 50x20 sRGB crop loop and save per-crop .mats."""
    import h5py
    import scipy.io as sio

    out_folder = Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)

    infos = h5py.File(str(Path(data_folder) / "info.mat"), "r")
    info = infos["info"]
    bb = info["boundingboxes"]
    for i in range(50):
        filename = Path(data_folder) / "images_srgb" / f"{i + 1:04d}.mat"
        img = h5py.File(str(filename), "r")
        inoisy = np.float32(np.array(img["InoisySRGB"])).T
        boxes = np.array(info[bb[0][i]]).T
        for k in range(20):
            idx = [int(boxes[k, 0] - 1), int(boxes[k, 2]),
                   int(boxes[k, 1] - 1), int(boxes[k, 3])]
            crop = inoisy[idx[0]:idx[1], idx[2]:idx[3], :].copy()
            # the official loop hands the denoiser the per-image NLF params
            # (dnd_denoise.py:112-117); VIRNet's wrapper ignores them
            denoised = np.float32(denoiser(crop, load_nlf(info, i)))
            sio.savemat(str(out_folder / f"{i + 1:04d}_{k + 1:02d}.mat"),
                        {"Idenoised_crop": denoised})
        log_fn(f"[{i + 1}/50] {filename.name} done")


def load_nlf(info, img_id):
    """Noise-level-function params from info.mat (official protocol)."""
    nlf_h5 = info[info["nlf"][0][img_id]]
    return {"a": nlf_h5["a"][0][0], "b": nlf_h5["b"][0][0]}


def load_sigma_raw(info, img_id, bb, yy, xx):
    return info[info["sigma_raw"][0][img_id]][xx, yy, bb]


def load_sigma_srgb(info, img_id, bb):
    return info[info["sigma_srgb"][0][img_id]][0, bb]


def denoise_raw(denoiser: Callable, data_folder, out_folder,
                log_fn=print) -> None:
    """Raw-Bayer DND loop (reference dnd_submission_py/dnd_denoise.py:29-76):
    each crop's four Bayer phases are denoised independently with their own
    σ from info.mat and re-interleaved."""
    import h5py
    import scipy.io as sio

    out_folder = Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)

    infos = h5py.File(str(Path(data_folder) / "info.mat"), "r")
    info = infos["info"]
    bb = info["boundingboxes"]
    for i in range(50):
        filename = Path(data_folder) / "images_raw" / f"{i + 1:04d}.mat"
        img = h5py.File(str(filename), "r")
        inoisy = np.float32(np.array(img["Inoisy"])).T
        boxes = np.array(info[bb[0][i]]).T
        for k in range(20):
            idx = [int(boxes[k, 0] - 1), int(boxes[k, 2]),
                   int(boxes[k, 1] - 1), int(boxes[k, 3])]
            crop = inoisy[idx[0]:idx[1], idx[2]:idx[3]].copy()
            denoised = crop.copy()
            h, w = crop.shape
            nlf = load_nlf(info, i)
            for yy in range(2):
                for xx in range(2):
                    nlf["sigma"] = load_sigma_raw(info, i, k, yy, xx)
                    phase = crop[yy:h:2, xx:w:2].copy()
                    denoised[yy:h:2, xx:w:2] = denoiser(phase, nlf)
            sio.savemat(str(out_folder / f"{i + 1:04d}_{k + 1:02d}.mat"),
                        {"Idenoised_crop": np.float32(denoised)})
        log_fn(f"[{i + 1}/50] {filename.name} done")


def _bundle(submission_folder, israw: bool) -> None:
    """Bundle per-crop .mats into per-image object arrays for upload
    (eval_version 1.0)."""
    import scipy.io as sio

    submission_folder = Path(submission_folder)
    out_folder = submission_folder / "bundled"
    out_folder.mkdir(exist_ok=True)
    for i in range(50):
        denoised = np.zeros((20,), dtype=object)
        for k in range(20):
            s = sio.loadmat(str(submission_folder
                                / f"{i + 1:04d}_{k + 1:02d}.mat"))
            denoised[k] = s["Idenoised_crop"]
        sio.savemat(str(out_folder / f"{i + 1:04d}.mat"),
                    {"Idenoised": denoised, "israw": israw,
                     "eval_version": "1.0"})


def bundle_submissions_raw(submission_folder) -> None:
    """Bundle the raw track's per-crop .mats (israw=True)."""
    _bundle(submission_folder, True)


def bundle_submissions_srgb(submission_folder) -> None:
    """Bundle the sRGB track's per-crop .mats (israw=False)."""
    _bundle(submission_folder, False)
