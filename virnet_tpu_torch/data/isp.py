"""Camera-ISP simulation for HR-patch preparation (counterpart of
virnet_tpu/data/isp.py; the function of the reference's ISP prepare
variant, datasets/prepare_data/SISR/prepare_patch_isp.py:41-60).

A clean sRGB patch is pushed backwards through a randomized camera model
to a raw Bayer mosaic, then re-rendered forward through the same camera's
ISP: a clean patch that carries a genuine ISP footprint (white-balance and
CCM colour rendition, demosaic interpolation, tone curve).  The reference
imports ``camera_isp.ISP_implement.ISP``, a module absent from the
reference repository, so this is a re-design with the same surface
(``reset_seed`` / ``random_config`` / ``save_config`` /
``simulate_clean``) and the same prepare layout
(``<isp_dir>/images/*.png`` + ``<isp_dir>/meta/*``).

Pipeline (host numpy and cv2 in float64: offline data preparation, not
the training hot path):

  unprocess:  sRGB -> inverse tone ('func') -> inverse sRGB gamma
              -> inverse CCM -> inverse WB gains -> RGGB mosaic
  process:    WB gains -> demosaic (Malvar-He-Cutler 2004 linear;
              'bilinear' fallback) -> CCM -> sRGB gamma -> tone

The random camera samples WB gains, a row-normalized CCM (a random convex
combination of a small bank of plausible cameras) and an invertible
S-shaped tone curve f(x) = (1+s^m) x^m / (x^m + s^m).  The reference's
'Menon' edge-directed demosaic is replaced by Malvar-He-Cutler (linear
5x5, closed form); the method string stays in the config so the
substitution is visible in the metadata.

Worker processes of ``isp_process_patches`` import this module, so it
imports nothing that builds a kernel or touches the card.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.color import imread, imwrite

# cam -> linear-sRGB colour matrices, rows normalized to sum 1 (white
# preserving): warm to cool renditions, of which random_config draws a
# convex combination (the unprocessing construction of Brooks et al.)
_CCM_BANK = np.array([
    [[1.64, -0.54, -0.10], [-0.18, 1.46, -0.28], [0.02, -0.48, 1.46]],
    [[1.77, -0.64, -0.13], [-0.22, 1.69, -0.47], [0.05, -0.64, 1.59]],
    [[1.53, -0.40, -0.13], [-0.14, 1.36, -0.22], [-0.01, -0.40, 1.41]],
    [[1.90, -0.76, -0.14], [-0.28, 1.80, -0.52], [0.01, -0.56, 1.55]],
], dtype=np.float64)


def _srgb_to_linear(x):
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(x):
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def _tone_forward(x, m, s):
    # f(x) = (1+s^m) x^m / (x^m + s^m); f(0)=0, f(1)=1, S-shaped for m>1
    x = np.clip(x, 0.0, 1.0)
    sm = s ** m
    xm = np.power(x, m)
    return (1.0 + sm) * xm / (xm + sm)


def _tone_inverse(y, m, s):
    y = np.clip(y, 0.0, 1.0)
    sm = s ** m
    xm = sm * y / np.maximum((1.0 + sm) - y, 1e-12)
    return np.power(xm, 1.0 / m)


# --------------------------------------------------------------------------
# Bayer mosaic / demosaic (RGGB)
# --------------------------------------------------------------------------

def mosaic_rggb(im):
    """(H, W, 3) float -> (H, W) CFA plane, RGGB pattern."""
    h, w = im.shape[:2]
    cfa = np.empty((h, w), im.dtype)
    cfa[0::2, 0::2] = im[0::2, 0::2, 0]   # R
    cfa[0::2, 1::2] = im[0::2, 1::2, 1]   # G at R row
    cfa[1::2, 0::2] = im[1::2, 0::2, 1]   # G at B row
    cfa[1::2, 1::2] = im[1::2, 1::2, 2]   # B
    return cfa


def _conv5(plane, kern):
    # 'reflect' borders; float64 accumulation
    import cv2
    return cv2.filter2D(plane.astype(np.float64), -1, kern,
                        borderType=cv2.BORDER_REFLECT_101)


# Malvar-He-Cutler (ICASSP 2004) 5x5 linear demosaic filters, /8
_MHC_G_AT_RB = np.array([
    [0, 0, -1, 0, 0],
    [0, 0, 2, 0, 0],
    [-1, 2, 4, 2, -1],
    [0, 0, 2, 0, 0],
    [0, 0, -1, 0, 0]], np.float64) / 8.0
_MHC_RB_AT_G_SAMEROW = np.array([
    [0, 0, 0.5, 0, 0],
    [0, -1, 0, -1, 0],
    [-1, 4, 5, 4, -1],
    [0, -1, 0, -1, 0],
    [0, 0, 0.5, 0, 0]], np.float64) / 8.0
_MHC_RB_AT_G_SAMECOL = _MHC_RB_AT_G_SAMEROW.T.copy()
_MHC_RB_AT_BR = np.array([
    [0, 0, -1.5, 0, 0],
    [0, 2, 0, 2, 0],
    [-1.5, 0, 6, 0, -1.5],
    [0, 2, 0, 2, 0],
    [0, 0, -1.5, 0, 0]], np.float64) / 8.0


def demosaic_malvar(cfa):
    """Malvar-He-Cutler linear demosaic of an RGGB CFA plane: each filter
    runs over the whole plane and each pixel takes the result its Bayer
    position selects (the 2004 paper's coefficient tables).  Returns
    (H, W, 3) float64."""
    h, w = cfa.shape
    g_est = _conv5(cfa, _MHC_G_AT_RB)
    rb_row = _conv5(cfa, _MHC_RB_AT_G_SAMEROW)
    rb_col = _conv5(cfa, _MHC_RB_AT_G_SAMECOL)
    rb_x = _conv5(cfa, _MHC_RB_AT_BR)

    r = np.empty((h, w), np.float64)
    g = np.empty((h, w), np.float64)
    b = np.empty((h, w), np.float64)

    # green: native at G sites, estimated at R/B sites
    g[0::2, 1::2] = cfa[0::2, 1::2]
    g[1::2, 0::2] = cfa[1::2, 0::2]
    g[0::2, 0::2] = g_est[0::2, 0::2]
    g[1::2, 1::2] = g_est[1::2, 1::2]

    # red: native at R; same-row at G-in-R-row; same-col at G-in-B-row;
    # cross at B
    r[0::2, 0::2] = cfa[0::2, 0::2]
    r[0::2, 1::2] = rb_row[0::2, 1::2]
    r[1::2, 0::2] = rb_col[1::2, 0::2]
    r[1::2, 1::2] = rb_x[1::2, 1::2]

    # blue: mirror of red
    b[1::2, 1::2] = cfa[1::2, 1::2]
    b[1::2, 0::2] = rb_row[1::2, 0::2]
    b[0::2, 1::2] = rb_col[0::2, 1::2]
    b[0::2, 0::2] = rb_x[0::2, 0::2]

    return np.stack([r, g, b], axis=-1)


def demosaic_bilinear(cfa):
    """Bilinear demosaic (the fallback method)."""
    import cv2
    h, w = cfa.shape
    kg = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], np.float64) / 4.0
    krb = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float64) / 4.0
    mr = np.zeros((h, w)); mr[0::2, 0::2] = 1.0
    mg = np.zeros((h, w)); mg[0::2, 1::2] = 1.0; mg[1::2, 0::2] = 1.0
    mb = np.zeros((h, w)); mb[1::2, 1::2] = 1.0

    def interp(mask, kern):
        num = cv2.filter2D(cfa * mask, -1, kern,
                           borderType=cv2.BORDER_REFLECT_101)
        den = cv2.filter2D(mask, -1, kern,
                           borderType=cv2.BORDER_REFLECT_101)
        return num / np.maximum(den, 1e-12)

    return np.stack([interp(mr, krb), interp(mg, kg), interp(mb, krb)],
                    axis=-1)


_DEMOSAIC = {"malvar": demosaic_malvar, "menon": demosaic_malvar,
             "bilinear": demosaic_bilinear}


# --------------------------------------------------------------------------
# The ISP object (the surface of the reference's camera_isp ISP)
# --------------------------------------------------------------------------

class CameraISP:
    """Randomized camera model: unprocess and re-render clean sRGB patches.

    The surface of the reference's absent ``ISP`` class as
    prepare_patch_isp.py uses it: ``reset_seed(seed)`` ->
    ``random_config()`` -> ``save_config(path)`` ->
    ``simulate_clean(im_rgb_float)``.
    """

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self.config: Optional[dict] = None

    # -- config ------------------------------------------------------------
    def reset_seed(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def random_config(self) -> dict:
        rng = self._rng
        wts = rng.dirichlet(np.ones(len(_CCM_BANK)))
        ccm = np.tensordot(wts, _CCM_BANK, axes=1)
        ccm = ccm / ccm.sum(axis=1, keepdims=True)   # keep rows at 1
        self.config = {
            "wb_gains": [float(rng.uniform(1.6, 2.4)), 1.0,
                         float(rng.uniform(1.4, 2.2))],
            "ccm": ccm.tolist(),
            "tone_m": float(rng.uniform(0.85, 1.35)),
            "tone_s": float(rng.uniform(0.45, 0.75)),
            "demosaic_method": "malvar",
            "pattern": "rggb",
        }
        return self.config

    def save_config(self, path):
        # JSON, not pickle: the role of the reference's .pkl sidecar in an
        # inspectable format that runs no code when read
        Path(path).write_text(json.dumps(self.config, indent=1))

    def load_config(self, path):
        self.config = json.loads(Path(path).read_text())
        return self.config

    # -- pipeline ----------------------------------------------------------
    def unprocess(self, im_srgb, tone_type: str = "func"):
        """sRGB float (H, W, 3) -> raw RGGB CFA plane.  The raw domain is
        clipped to [0, 1]: the inverse WB can push values above 1, but
        ``process`` clips its camera-domain input the same way, so the
        headroom would only hold values it cannot render."""
        cfg = self.config
        x = np.asarray(im_srgb, np.float64)
        if tone_type == "func":
            x = _tone_inverse(x, cfg["tone_m"], cfg["tone_s"])
        lin = _srgb_to_linear(np.clip(x, 0.0, 1.0))
        ccm_inv = np.linalg.inv(np.asarray(cfg["ccm"]))
        cam = lin @ ccm_inv.T
        raw = cam / np.asarray(cfg["wb_gains"])[None, None, :]
        return mosaic_rggb(np.clip(raw, 0.0, 1.0))

    def process(self, cfa, tone_type: str = "func",
                demosaic_method: Optional[str] = None):
        """Raw RGGB CFA plane -> rendered sRGB float (H, W, 3)."""
        cfg = self.config
        method = (demosaic_method or cfg["demosaic_method"]).lower()
        cam = _DEMOSAIC[method](np.asarray(cfa, np.float64))
        cam = cam * np.asarray(cfg["wb_gains"])[None, None, :]
        cam = np.clip(cam, 0.0, 1.0)
        lin = cam @ np.asarray(cfg["ccm"]).T
        srgb = _linear_to_srgb(lin)
        if tone_type == "func":
            srgb = _tone_forward(srgb, cfg["tone_m"], cfg["tone_s"])
        return np.clip(srgb, 0.0, 1.0)

    def simulate_clean(self, im_srgb, tone_type: str = "func",
                       demosaic_method: str = "malvar"):
        """Clean sRGB in -> ISP-rendered clean sRGB out: the same scene
        with a camera pipeline's footprint (the reference call
        prepare_patch_isp.py:57; its 'Menon' is the Malvar demosaic here,
        recorded in the config)."""
        if self.config is None:
            self.random_config()
        cfa = self.unprocess(im_srgb, tone_type=tone_type)
        return self.process(cfa, tone_type=tone_type,
                            demosaic_method=demosaic_method)


# the name of the reference class it stands in for
ISP = CameraISP


def _isp_patch_job(job) -> int:
    """One patch's ISP re-render (module-level, so that it pickles into
    worker processes)."""
    idx, path, im_dir, meta_dir, tone_type, demosaic_method = job
    path = Path(path)
    im = imread(path, chn="rgb", dtype="float32")
    isp = CameraISP()
    isp.reset_seed(idx)
    isp.random_config()
    isp.save_config(Path(meta_dir) / (path.stem + ".json"))
    out = isp.simulate_clean(im, tone_type=tone_type,
                             demosaic_method=demosaic_method)
    out8 = np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)
    imwrite(out8, Path(im_dir) / path.name, chn="rgb")
    return 1


def isp_process_patches(pch_dir, isp_dir, pattern: str = "*.png",
                        max_workers: int = 8, tone_type: str = "func",
                        demosaic_method: str = "malvar") -> int:
    """ISP-re-render every HR patch (the prepare_patch_isp.py pipeline).

    The layout is the reference's: ``<isp_dir>/images/<name>.png`` +
    ``<isp_dir>/meta/<stem>.json``; a patch's seed is its index in sorted
    order, as in prepare_patch_isp.py:31,49.  The jobs run in worker
    processes (the float64 numpy and cv2 work holds the interpreter lock,
    so threads would take turns), in this process with ``max_workers`` <= 1
    or a single patch, or when the pool cannot start (where processes
    may not be created).  Returns the number of patches.
    """
    pch_dir = Path(pch_dir)
    isp_dir = Path(isp_dir)
    im_dir = isp_dir / "images"
    meta_dir = isp_dir / "meta"
    im_dir.mkdir(parents=True, exist_ok=True)
    meta_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(idx, str(path), str(im_dir), str(meta_dir), tone_type,
             demosaic_method)
            for idx, path in enumerate(sorted(pch_dir.glob(pattern)))]
    if max_workers <= 1 or len(jobs) <= 1:
        return sum(map(_isp_patch_job, jobs))
    try:
        import multiprocessing

        # spawn, not fork: the parent has PyTorch's thread pools (and maybe
        # a CUDA context), and forking a multithreaded process can deadlock
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=max_workers,
                                    mp_context=ctx) as ex:
            return sum(ex.map(_isp_patch_job, jobs,
                              chunksize=max(1, len(jobs) // max_workers)))
    except (OSError, PermissionError):
        return sum(map(_isp_patch_job, jobs))
