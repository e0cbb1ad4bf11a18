"""Inference engine (counterpart of virnet_tpu/eval/engine.py:Restorer).

The forward is the model's own.  Denoising: K3 + RNet + K4 on shapes that
pass the fused-head gate, K2 + RNet + K4 on the others; SISR: K2 (SNet),
KNet and RNet in torch, K4 (models/virnet.py).  ``mesh`` (train/mesh.py)
splits every batch over the mesh's devices, and
``restore_image_sharded`` splits one image's rows over them
(eval/spatial.py) in fp32 whatever the compute, as the JAX engine's
stages do.  ``compute='int8'`` builds ``conv_impl='torch'``, so that every
convolution goes through ``models/common.conv`` and the int8 gate: no K2,
K3 or K4 runs in that mode (SNet's first and last convs and RNet's head,
strided, transposed and tail convs are bf16 library convolutions), and
the gated ones are W8A8 on K10 + K9.

Copies between host and card.  A numpy request on a card engine crosses
both ways through page-locked blocks of PyTorch's caching host allocator
(``torch.empty(..., pin_memory=True)``): ATen's CPU copy stages the input
in one and the copy to the card runs without blocking the host; the
result is copied into another, which ``restore_batch`` returns (``.cpu()``
on it is a no-op, ``.numpy()`` a view).  A tensor request keeps its result
on the engine's device, and on the CPU nothing is pinned.  ``COPIES``
counts the copies each way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import load_pth
from ..models import ARCH_PRESETS, build_model
from ..models.common import cast_for_int8
from ..ops.augment import dihedral_inverse_np, dihedral_np
from ..ops.pad import pad_bottom_right
from ..ops.qconv import run_lockstep
from ..precision import (compute_dtype, im2col_convs, int8_convs,
                         resolve_device, set_parity_mode)
from .profiling import span
from .spatial import (replicas, restore_rows_sharded,
                      sr_restore_rows_sharded)
from .tiling import bucket_size, forward_chop

CHOP_THRESHOLD = 160000   # pixels; above this, quadrant tiling kicks in

# The Restorer's copies between host and card, one each way a request that
# crosses: page-locked (numpy requests, results returned to the host) or
# pageable (a host tensor handed in; no result goes out pageable).
COPIES = dict.fromkeys(("pinned_in", "pinned_out", "pageable_in",
                        "pageable_out"), 0)


def _to_device(x, device) -> torch.Tensor:
    """``x`` (numpy or tensor) as a float32 tensor on ``device``.  On a
    card, numpy goes through a page-locked block of the caching host
    allocator: ATen's CPU copy stages it there, converting the dtype as
    ``torch.as_tensor`` would, and the copy to the card does not block the
    host (the allocator keeps the block until that copy has finished)."""
    if device.type != "cuda":
        return torch.as_tensor(x, dtype=torch.float32).to(device)
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu":
            COPIES["pinned_in" if x.is_pinned() else "pageable_in"] += 1
        return torch.as_tensor(x, dtype=torch.float32).to(device)
    src = torch.as_tensor(x)
    block = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
    block.copy_(src)
    COPIES["pinned_in"] += 1
    return block.to(device, non_blocking=True)


def _to_host(y: torch.Tensor) -> torch.Tensor:
    """``y`` copied from the card into a page-locked block of the caching
    host allocator, returned once the copy has finished (``y`` itself where
    it is on the host already).  Nothing here keeps the block: the
    allocator reuses it once the caller drops it."""
    if y.device.type == "cpu":
        return y
    out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    # wait for the forward, so that the span times the copy alone
    torch.cuda.current_stream(y.device).synchronize()
    with span("engine.copy_out"):
        out.copy_(y)              # blocking: returns with the copy done
    COPIES["pinned_out"] += 1
    return out


class Restorer:
    """Denoising and SISR inference on HWC float32 numpy images, with the
    weights of a reference ``.pth`` (``ckpt_path``) or a state dict in
    memory (``state_dict``, the JAX Restorer's ``params``).  ``sf`` is the SISR
    scale factor (outputs are ``sf`` times the input's size); the
    denoising tasks ignore it.

    ``compute='fp32'`` is the checkpoint-faithful parity mode (TF32 off;
    on the card the library convolutions take PyTorch's im2col route
    instead of cuDNN, ``precision.im2col_convs``; ``self.im2col`` holds
    that choice);
    ``'bf16'`` runs bf16 weights and activations with an fp32 image in and
    out; ``'int8'`` is quantized serving (the JAX engine's): the
    convolutions that the int8 gate takes (``models/common.int8_gated``:
    SNet's mids, RNet's body convs, the wide SFT 1x1 convs, KNet's body)
    run W8A8 from their fp32 weights with scales over the whole batch
    (ops/qconv.py, K10 + K9 on the card), everything else as in bf16; the
    model is built with ``conv_impl='torch'`` (module docstring), so K4
    does not take the tail in this mode.  Not checkpoint-faithful.
    ``restore_image_sharded`` runs fp32 in every compute.  With a
    ``mesh`` the chunks of a batch run in lockstep, one thread each, and
    take every scale over the whole batch, as the JAX engine's jit over a
    sharded batch does.  ``pad_multiple=0`` feeds the model the raw image (the
    reference's semantics); > 0 reflect-pads to size buckets first.
    ``gray_mean=True`` averages a gray input's 3-channel restoration back
    to one channel.  ``device`` defaults to the card; the CPU runs the
    kernels' plain versions and must be asked for.  ``mesh``
    (train/mesh.py) turns on data-parallel inference: one replica of the
    weights per distinct device, and every ``restore_batch`` repeat-pads
    its batch to a multiple of the mesh's size, runs one chunk per mesh
    device and crops the result (per-image outputs as without the mesh,
    up to the summation order of another batch size).  Extra keyword
    arguments go to ``build_model`` (e.g. ``conv_impl='torch'``)."""

    def __init__(self, task: str, ckpt_path=None, sf: int = 2,
                 pad_multiple: int = 0, gray_mean: bool = False,
                 compute: str = "fp32", device="cuda", state_dict=None,
                 mesh=None, **model_overrides):
        if task not in ARCH_PRESETS:
            raise ValueError(f"task must be one of {sorted(ARCH_PRESETS)}, "
                             f"got {task!r}")
        self.sisr = ARCH_PRESETS[task].get("cls") == "VIRNetSR"
        self._fp32_overrides = dict(model_overrides)
        self.sf = sf if self.sisr else 1
        self.device = resolve_device(device)
        self.int8 = compute == "int8"
        dtype = compute_dtype("bf16" if self.int8 else compute)
        if self.int8:
            if model_overrides.get("conv_impl", "torch") != "torch":
                raise ValueError("compute='int8' runs every convolution "
                                 "through the int8 gate: it builds "
                                 "conv_impl='torch', not "
                                 f"{model_overrides['conv_impl']!r}")
            model_overrides = dict(model_overrides, conv_impl="torch")
        if self.device.type == "cuda":
            set_parity_mode()
        self.task = task
        self.compute = compute
        self.pad_multiple = pad_multiple
        self.gray_mean = gray_mean
        if state_dict is None:
            if ckpt_path is None:
                raise ValueError("need ckpt_path or state_dict")
            state_dict = load_pth(ckpt_path)
        self.model_overrides = model_overrides
        model = build_model(task, **model_overrides)
        model.load_state_dict(state_dict, strict=True)
        self.model = (cast_for_int8(model.to(self.device), dtype)
                      if self.int8 else model.to(self.device, dtype)).eval()
        self.int8_dtype = dtype if self.int8 else None
        self.im2col = compute == "fp32" and self.device.type == "cuda"
        # row-sharded restores run the fp32 model of these weights: kept
        # here, built at the first such restore (``_fp32_model``)
        self._state_dict = None if compute == "fp32" else state_dict
        self._fp32 = None
        self.mesh = mesh
        self.replicas = {self.device: self.model}
        if mesh is not None:
            self.replicas = replicas(self.model, mesh, self.replicas)

    def _forward(self, x: torch.Tensor, device) -> torch.Tensor:
        """mu of the replica on ``device`` for an NHWC float32 batch."""
        x = x.to(device).contiguous()
        with torch.inference_mode(), im2col_convs(self.im2col), \
                int8_convs(self.int8_dtype):
            if self.sisr:
                mu, _, _ = self.replicas[device](x, self.sf)
            else:
                mu, _ = self.replicas[device](x)
        return mu

    def restore_batch(self, x) -> torch.Tensor:
        """NHWC float32 batch (numpy or tensor) -> restored NHWC float32
        tensor, clamped to [0, 1]; with a mesh, repeat-padded to a multiple
        of its size and run one chunk per mesh device (in int8, in lockstep
        threads sharing the batch's scales).  A tensor's result stays on
        the engine's device.  A numpy batch's comes back on the host: on a
        card, in a page-locked block that the copy has finished writing
        when this returns and that the engine does not keep (module
        docstring)."""
        to_host = not isinstance(x, torch.Tensor)
        with span("engine.restore_batch"):
            with span("engine.copy_in"):
                x = _to_device(x, self.device)
            if self.mesh is None:
                mu = self._forward(x, self.device)
            else:
                n, size = x.shape[0], self.mesh.size
                rem = (-n) % size
                if rem:
                    x = torch.cat([x, x[-1:].expand(rem, *x.shape[1:])])
                calls = [lambda c=c, dev=dev: self._forward(c, dev)
                         for c, dev in zip(x.chunk(size), self.mesh.devices)]
                chunks = (run_lockstep(calls) if self.int8
                          else [call() for call in calls])
                mu = torch.cat([c.to(self.device) for c in chunks])[:n]
            y = torch.clamp(mu.float(), 0.0, 1.0)
            return _to_host(y) if to_host else y

    def _fp32_model(self, mesh):
        """(model, its replicas on ``mesh``) that row-sharded restores run:
        ``Restorer(compute='fp32')``'s, with the float32 weights of the
        state dict this engine was built from (a bf16 model cast back would
        have lost their low bits) and the same ``conv_impl``."""
        if self.compute == "fp32":
            self.replicas = replicas(self.model, mesh, self.replicas)
            return self.model, self.replicas
        if self._fp32 is None:
            model = build_model(self.task, **self._fp32_overrides)
            model.load_state_dict(self._state_dict, strict=True)
            model = model.to(self.device).eval()
            self._fp32 = (model, {self.device: model})
        model, have = self._fp32
        self._fp32 = (model, replicas(model, mesh, have))
        return self._fp32

    def restore_image_sharded(self, im: np.ndarray, mesh=None,
                              halo: int = 160) -> np.ndarray:
        """Restore one huge image with its rows sharded over ``mesh``
        (default: the engine's, else every visible card, or the engine's
        device alone on the CPU; eval/spatial.py): restore_image's raw
        whole-image forward in fp32 up to summation order (the SISR sigma
        pool is summed over the stitched map), clamped to [0, 1].  The
        strips run fp32 whatever ``compute`` is, as the JAX engine's
        sharded stages do: the model ``Restorer(compute='fp32')`` would
        run (``_fp32_model``), on the card on the im2col route."""
        from ..train.mesh import make_mesh

        squeeze_gray = im.ndim == 2
        if squeeze_gray:
            im = np.stack([im] * 3, axis=2)
        mesh = mesh or self.mesh or (make_mesh() if self.device.type ==
                                     "cuda" else make_mesh([self.device]))
        model, reps = self._fp32_model(mesh)
        im2col = (self.im2col if self.compute == "fp32"
                  else self.device.type == "cuda")
        with im2col_convs(im2col):
            if self.sisr:
                out = sr_restore_rows_sharded(model, im, self.sf, mesh,
                                              halo=halo, models=reps)
            else:
                out = restore_rows_sharded(model, im, mesh, halo=halo,
                                           models=reps)
        out = np.clip(out, 0.0, 1.0)
        if squeeze_gray and self.gray_mean:
            out = out.mean(axis=2)
        return out

    def _restore_padded(self, batch: np.ndarray) -> np.ndarray:
        """Restore an NHWC numpy batch at its bucket size, cropped back."""
        h, w = batch.shape[1:3]
        hb = bucket_size(h, self.pad_multiple)
        wb = bucket_size(w, self.pad_multiple)
        if hb != h or wb != w:
            batch = np.pad(batch, ((0, 0), (0, hb - h), (0, wb - w), (0, 0)),
                           mode="reflect")
        sf = self.sf
        return self.restore_batch(batch)[:, :h * sf, :w * sf].numpy()

    def restore_image(self, im: np.ndarray) -> np.ndarray:
        """HWC float32 [0, 1] -> restored HWC.  Gray inputs are stacked to
        3 channels; images above ``CHOP_THRESHOLD`` pixels run through
        overlap-shave quadrant tiling."""
        with span("engine.restore_image"):
            return self._restore_image(im)

    def _restore_image(self, im: np.ndarray) -> np.ndarray:
        squeeze_gray = im.ndim == 2
        if squeeze_gray:
            im = np.stack([im] * 3, axis=2)
        h, w = im.shape[:2]
        if h * w > CHOP_THRESHOLD:
            def fwd(x):
                hh, ww = x.shape[1], x.shape[2]
                x = pad_bottom_right(x, bucket_size(hh, self.pad_multiple),
                                     bucket_size(ww, self.pad_multiple))
                return self.restore_batch(x)[:, :hh * self.sf,
                                             :ww * self.sf]

            with span("engine.copy_in"):
                x = _to_device(im[None], self.device)
            out = _to_host(forward_chop(fwd, x, sf=self.sf, shave=10,
                                        min_size=CHOP_THRESHOLD)[0]).numpy()
        else:
            out = self._restore_padded(im[None])[0]
        if squeeze_gray and self.gray_mean:
            out = out.mean(axis=2)
        return out

    def restore_image_tta(self, im: np.ndarray) -> np.ndarray:
        """x8 flip/rotation self-ensemble of restore_image, the
        orientations batched per shape (one forward for square images,
        two for rectangular ones)."""
        squeeze_gray = im.ndim == 2
        im3 = np.stack([im] * 3, axis=2) if squeeze_gray else im
        h, w = im3.shape[:2]
        if h * w > CHOP_THRESHOLD:
            outs = [dihedral_inverse_np(
                self.restore_image(dihedral_np(im3, m)), m)
                for m in range(8)]
        else:
            oriented = [dihedral_np(im3, m) for m in range(8)]
            outs: list = [None] * 8
            for shape in dict.fromkeys(o.shape[:2] for o in oriented):
                modes = [m for m in range(8) if oriented[m].shape[:2] == shape]
                y = self._restore_padded(np.stack([oriented[m]
                                                   for m in modes]))
                for m, o in zip(modes, y):
                    outs[m] = dihedral_inverse_np(o, m)
        out = np.mean(outs, axis=0).astype(np.float32)
        if squeeze_gray and self.gray_mean:
            out = out.mean(axis=2)
        return out

    def restore_images(self, ims, batch_size: int = 8):
        """Restore a list of HWC float32 images, grouping same-shape images
        into batched forwards.  Returns outputs in input order."""
        outs: list = [None] * len(ims)
        groups: dict = {}
        for i, im in enumerate(ims):
            im3 = np.stack([im] * 3, axis=2) if im.ndim == 2 else im
            h, w = im3.shape[:2]
            if h * w > CHOP_THRESHOLD:
                outs[i] = self.restore_image(im)
            else:
                groups.setdefault((h, w), []).append((i, im3, im.ndim == 2))
        for group in groups.values():
            for s in range(0, len(group), batch_size):
                sub = group[s:s + batch_size]
                y = self._restore_padded(np.stack([g[1] for g in sub]))
                for (i, _, was_gray), o in zip(sub, y):
                    outs[i] = (o.mean(axis=2)
                               if was_gray and self.gray_mean else o)
        return outs
