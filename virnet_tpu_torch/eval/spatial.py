"""Row-sharded restoration of one huge image over a mesh (counterpart of
virnet_tpu/eval/spatial.py).

The reference handles huge images on one GPU by recursive 4-quadrant
tiling (utils/util_net.py:27-65, here eval/tiling.py).  Here one image's
rows are split over the mesh (train/mesh.py): each device runs the
network on halo-extended row windows, and the kept rows stitch back to
the whole-image forward up to float summation order.

Exactness follows the model's two-stage padding (networks/VIRNet.py:
42-45: SNet sees the raw input with per-layer zero padding at its true
edges, RNet reflect-pads the input to a multiple of 2^(depth-1) first),
so the stages shard separately:

* **SNet** is a stride-1 conv stack: its windows lie inside [0, H] and
  the first and last sit flush at the true edges, where their zero
  padding is the whole image's.  Interior kept rows lie at least ``halo``
  rows inside their window, beyond the receptive field.
* **RNet** takes (x, sqrt(sigma)) padded by the model's own
  pad_to_multiple, with windows on the 2^(depth-1) grid, so every
  stride-2 conv samples the rows the whole-image forward samples.

Each stage runs as one batch of windows per distinct device of the mesh
(``[cuda:0] * 4`` runs all four windows as one batch on one card), each
device with its own replica of the weights; the kept rows are stitched
on the mesh's first device.  On the card the denoising stages run K2 (the
SNet level chain) and RNet with K4 at its tail.

SISR (``sr_restore_rows_sharded``) splits further, because two of its
stages are global (networks/VIRNet.py:80-97): the ``noise_avg`` sigma is
the mean of the whole SNet map, taken here over the stitched map, and
KNet's channel attention pools over the whole image, so KNet runs whole
on the first device (on the LR image, a small cost).  RNet then shards
over the upsampled grid with the per-sample constant conditioning
compact.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..models.virnet import LOG_MAX, LOG_MIN, nearest_upsample
from ..ops.fused_conv import exp_clip
from ..ops.pad import pad_to_multiple


def plan_strips(height: int, n: int, halo: int, unit: int):
    """Static row-strip plan: kept height per shard and window starts.

    height must be a multiple of ``unit``.  Returns (kept, win, starts)
    with kept/win/starts[i] multiples of unit, len(starts) == n, every
    window inside [0, height], the first/last windows flush at 0/height.
    Raises ValueError when the image is too short to give each shard a
    full window (callers fall back to the plain forward).
    """
    if height % unit:
        raise ValueError(f"height {height} not a multiple of unit {unit}")
    halo = int(math.ceil(halo / unit) * unit)
    kept = int(math.ceil(height / (n * unit)) * unit)
    win = kept + 2 * halo
    if win > height:
        raise ValueError(
            f"image of {height} rows is too short for {n} shards with "
            f"halo {halo} (window {win}); use the plain forward")
    starts = [min(max(i * kept - halo, 0), height - win) for i in range(n)]
    return kept, win, starts


def replicas(model: torch.nn.Module, mesh,
             have: Optional[Dict] = None) -> Dict:
    """One copy of ``model`` per distinct device of ``mesh`` (the model
    itself on its own device), keeping those already in ``have``."""
    own = next(model.parameters()).device
    out = dict(have or {})
    for dev in mesh.distinct():
        if dev not in out:
            out[dev] = model if dev == own else copy.deepcopy(model).to(dev)
    return out


def _sharded_windows(fn, planes, h_total, halo, unit, mesh, models):
    """``fn(model, *windows)`` over the mesh's n halo-extended row windows
    of ``planes`` (HWC tensors on the mesh's first device, windowed
    together), one batch of windows per distinct device, and the kept rows
    stitched to (h_total, W, C_out) on the first device."""
    kept, win, starts = plan_strips(h_total, mesh.size, halo, unit)
    dev0 = mesh.devices[0]
    outs = []
    for dev in mesh.distinct():
        idx = [i for i, d in enumerate(mesh.devices) if d == dev]
        batches = [torch.stack([p[starts[i]:starts[i] + win] for i in idx])
                   .to(dev) for p in planes]
        outs.append((idx, fn(models[dev], *batches)))
    y0 = outs[0][1]
    out = torch.empty((h_total,) + tuple(y0.shape[2:]), dtype=y0.dtype,
                      device=dev0)
    for idx, y in outs:
        for j, i in enumerate(idx):
            k0, k1 = i * kept, min((i + 1) * kept, h_total)
            if k0 < h_total:
                out[k0:k1] = y[j, k0 - starts[i]:k1 - starts[i]].to(dev0)
    return out


def _sigma(model, xw):
    logits = model.SNet(xw)
    return exp_clip(logits, LOG_MIN, LOG_MAX).to(logits.dtype)


def _image(img, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img, np.float32)).to(device)


@torch.inference_mode()
def restore_rows_sharded(model, img: np.ndarray, mesh, halo: int = 160,
                         models: Optional[Dict] = None) -> np.ndarray:
    """Restore one HWC image of a denoising VIRNet with its rows sharded
    over ``mesh``.

    halo: overlap rows on each side of a strip; it must cover the
    network's receptive field for exactness.  The default 160 covers the
    released denoise architectures: their one-sided receptive fields are
    147 rows (denoising-real) and 71 (denoising-syn), as the JAX package
    measured them.  ``models``: replicas already made (``replicas``).

    Returns the restored HWC float32 image (mu).  An image too short to
    shard runs the plain whole-image forward.
    """
    unit = 2 ** (len(model.n_feat) - 1)
    models = replicas(model, mesh, models)
    dev0 = mesh.devices[0]
    x = _image(img, dev0)
    h, w = x.shape[:2]
    try:                       # shardability check only: fail fast here
        plan_strips(h, mesh.size, halo, 1)
        plan_strips(int(math.ceil(h / unit) * unit), mesh.size, halo, unit)
    except ValueError:
        return models[dev0](x[None])[0][0, :h, :w].float().cpu().numpy()

    sigma = _sharded_windows(_sigma, [x], h, halo, 1, mesh, models)
    xp = pad_to_multiple(x[None], unit)[0]
    ep = pad_to_multiple(torch.sqrt(sigma)[None], unit)[0]
    mu = _sharded_windows(lambda m, xw, ew: m.RNet(xw, ew), [xp, ep],
                          xp.shape[0], halo, unit, mesh, models)
    return mu[:h, :w].float().cpu().numpy()


@torch.inference_mode()
def sr_restore_rows_sharded(model, img_lr: np.ndarray, sf: int, mesh,
                            halo: int = 64,
                            models: Optional[Dict] = None) -> np.ndarray:
    """The SISR twin of ``restore_rows_sharded`` for a VIRNetSR model,
    stage by stage as VIRNetSR.forward (models/virnet.py):

    * the SNet map over raw-LR strips; with ``noise_avg`` the pool is the
      mean of the stitched map (the values the whole-image forward pools,
      summed in another order);
    * KNet on the whole LR image, on the first device;
    * RNet over strips of the nearest-upsampled input on the 2^(depth-1)
      grid, with the conditioning compact (N, 1, 1, E) where it is
      constant per sample.

    halo is in LR rows for the SNet stage and in HR rows for the RNet
    stage (the released SISR architecture's RNet sees 43 rows, as the JAX
    package measured it, so the default 64 covers it).  Returns the
    (H*sf, W*sf, C) restoration; an image too short to shard runs the
    plain forward.
    """
    unit = 2 ** (len(model.n_feat) - 1)
    models = replicas(model, mesh, models)
    dev0 = mesh.devices[0]
    x = _image(img_lr, dev0)
    h, w = x.shape[:2]
    try:
        plan_strips(h, mesh.size, halo, 1)
        plan_strips(int(math.ceil(h * sf / unit) * unit), mesh.size, halo,
                    unit)
    except ValueError:
        return models[dev0](x[None], sf)[0][0].float().cpu().numpy()

    # SNet: the strip-exact map, then the global pool (noise_avg)
    raw = _sharded_windows(lambda m, xw: m.SNet._stack(xw), [x], h, halo,
                           1, mesh, models)
    if model.noise_avg:
        raw = raw.mean(dim=(0, 1), keepdim=True)                 # (1, 1, C)
    sigma = exp_clip(raw, LOG_MIN, LOG_MAX).to(raw.dtype)

    # KNet: whole image (global channel-attention pools)
    kinfo = models[dev0].KNet(x[None])[0]                         # (3,)

    # RNet over the upsampled grid, conditioned as in VIRNetSR.forward
    x_up = nearest_upsample(x[None], sf)[0]
    compact = not model.noise_cond or model.noise_avg
    extras = []
    if model.kernel_cond:
        kmap = kinfo[None, None, :].to(x.dtype)                   # (1, 1, 3)
        if not compact:
            kmap = kmap.expand(*x_up.shape[:2], -1)
        extras.append(kmap)
    if model.noise_cond:
        s = torch.sqrt(sigma)
        extras.append((s if model.noise_avg
                       else nearest_upsample(s[None], sf)[0]).to(x.dtype))
    xp = pad_to_multiple(x_up[None], unit)[0]
    if not extras:
        mu = _sharded_windows(lambda m, xw: m.RNet(xw, None), [xp],
                              xp.shape[0], halo, unit, mesh, models)
    elif compact:
        e = torch.cat(extras, dim=-1)[None]                   # (1, 1, 1, E)
        mu = _sharded_windows(
            lambda m, xw: m.RNet(xw, e.to(xw.device).expand(
                xw.shape[0], -1, -1, -1)),
            [xp], xp.shape[0], halo, unit, mesh, models)
    else:
        ep = pad_to_multiple(torch.cat(extras, dim=-1)[None], unit)[0]
        mu = _sharded_windows(lambda m, xw, ew: m.RNet(xw, ew), [xp, ep],
                              xp.shape[0], halo, unit, mesh, models)
    return mu[:h * sf, :w * sf].float().cpu().numpy()
