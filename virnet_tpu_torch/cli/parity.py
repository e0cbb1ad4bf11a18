"""Released-checkpoint parity of the port against the reference's own torch
networks (counterpart of virnet_tpu/cli/parity.py).

Given the reference's ``.pth`` files and a checkout of the reference code
(``--ref_dir``, the folder that holds ``networks/``), runs the port and the
reference's model classes over the benchmark tables' eval sets with the
port's data and metric pipelines, and prints ΔPSNR/ΔSSIM per case against
the ±0.01 dB goal; the data pipeline is shared, so a delta is a forward's.
Both run in fp32 with TF32 off, on the card unless ``--device cpu``:

    python -m virnet_tpu_torch.cli.parity --task denoising-syn \
        --ref_dir <reference checkout> \
        --ckpt_path model_zoo/virnet_denoising_syn.pth [--limit 4]
    python -m virnet_tpu_torch.cli.parity --task sisr --sf 4 \
        --ref_dir <reference checkout> --ckpt_path model_zoo/virnet_sisr_x4.pth
    python -m virnet_tpu_torch.cli.parity --task all --ref_dir <...>

``--data_root`` (default ``<ref_dir>/test_data``) holds ``CBSD68/*.png``,
``McMaster/*.tif`` (or ``*.png``) and ``Set14/*.bmp``; ``--sidd_dir`` adds
SIDD Table 4 for denoising-real.  Protocols: reference
scripts/testing_demo.py:21-75 (the models), scripts/denoising_virnet_syn.py
(Tables 1/2), scripts/sisr_virnet_syn.py (Table 5).  Exit code 0 when every
case is within the goal, 1 when one is not, 2 when no checkpoint was
found.
"""

from __future__ import annotations

import argparse
import sys
import types
from pathlib import Path

import numpy as np
import torch

GOAL_DB = 0.01
ZOO = {"denoising-syn": "model_zoo/virnet_denoising_syn.pth",
       "denoising-real": "model_zoo/virnet_denoising_real.pth",
       "sisr": "model_zoo/virnet_sisr_x{sf}.pth"}


# --------------------------------------------------------------- reference

def import_reference_networks(ref_dir):
    """The reference's VIRAttResUNet and VIRAttResUNetSR from
    ``<ref_dir>/networks/VIRNet.py`` (``thop``, which they import for FLOP
    counts only, is stubbed when absent; a ``networks`` package imported
    before, from another folder, is dropped first)."""
    for name in [m for m in sys.modules
                 if m == "networks" or m.startswith("networks.")]:
        del sys.modules[name]
    if "thop" not in sys.modules:
        thop = types.ModuleType("thop")
        thop.profile = None
        sys.modules["thop"] = thop
    sys.path.insert(0, str(ref_dir))
    try:
        from networks.VIRNet import VIRAttResUNet, VIRAttResUNetSR
    finally:
        sys.path.remove(str(ref_dir))
    return VIRAttResUNet, VIRAttResUNetSR


def build_reference_model(task: str, ckpt_path, ref_dir):
    """The reference model of ``task`` with the checkpoint's weights
    (scripts/testing_demo.py:21-75, ``module.`` stripped as at :69-72), in
    eval mode on the CPU."""
    VIRAttResUNet, VIRAttResUNetSR = import_reference_networks(ref_dir)
    if task == "denoising-syn":
        net = VIRAttResUNet(im_chn=3, sigma_chn=1, n_feat=[96, 192, 288],
                            dep_S=5, n_resblocks=3, noise_cond=True,
                            extra_mode="Input", noise_avg=False)
    elif task == "denoising-real":
        net = VIRAttResUNet(im_chn=3, sigma_chn=3,
                            n_feat=[96, 160, 224, 288], dep_S=8,
                            n_resblocks=3, noise_cond=True,
                            extra_mode="Input", noise_avg=False)
    elif task == "sisr":
        net = VIRAttResUNetSR(im_chn=3, sigma_chn=1, kernel_chn=3,
                              n_feat=[96, 160, 224], dep_S=5, dep_K=8,
                              n_resblocks=2, noise_cond=True,
                              kernel_cond=True, extra_mode="Both",
                              noise_avg=True)
    else:
        raise ValueError(f"unknown task {task!r}")
    state = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model_state_dict" in state:
        state = state["model_state_dict"]
    net.load_state_dict({k.removeprefix("module."): v
                         for k, v in state.items()}, strict=True)
    return net.eval()


class ReferenceRestorer:
    """The reference model behind the interface the port's table harnesses
    drive (``device``, ``restore_batch``, ``_restore_padded``), in fp32.
    The reference reflect-pads inside its forward, so no bucket padding."""

    def __init__(self, task: str, ckpt_path, ref_dir, sf: int = 2,
                 device="cuda"):
        from ..precision import resolve_device, set_parity_mode

        self.task = task
        self.sf = sf if task == "sisr" else 1
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_parity_mode()
        self.net = build_reference_model(task, ckpt_path, ref_dir).to(
            self.device)

    def restore_batch(self, x) -> torch.Tensor:
        """NHWC float32 batch -> the reference's mu, NHWC on the device,
        clamped to [0, 1]."""
        t = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        t = t.permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            mu = (self.net(t, self.sf) if self.task == "sisr"
                  else self.net(t))[0]
        return mu.clamp(0.0, 1.0).permute(0, 2, 3, 1)

    def _restore_padded(self, batch: np.ndarray) -> np.ndarray:
        return self.restore_batch(batch).cpu().numpy()


# ------------------------------------------------------------------ driving

def _delta_table(name: str, rows) -> int:
    """Print per-case ΔPSNR/ΔSSIM of (label, port, reference) rows; returns
    the number of rows outside the goal."""
    bad = 0
    print(f"\n== {name} ==")
    print(f"{'case':>24s} {'PSNR(port)':>10s} {'PSNR(ref)':>10s} "
          f"{'ΔdB':>8s} {'ΔSSIM':>9s}")
    for label, a, b in rows:
        dpsnr = a["psnr"] - b["psnr"]
        dssim = a["ssim"] - b["ssim"]
        off = abs(dpsnr) > GOAL_DB
        bad += off
        print(f"{label:>24s} {a['psnr']:10.3f} {b['psnr']:10.3f} "
              f"{dpsnr:+8.4f} {dssim:+9.5f}"
              f"{'  <-- >0.01 dB' if off else ''}")
    return bad


def _sets(data_root: Path, names, limit: int):
    """(stem, uint8 RGB) lists of the eval sets that exist under
    ``data_root``, each cut to its first ``limit`` images (0: all)."""
    from ..eval.tables import read_set

    out = {}
    for name, patterns in names.items():
        for pattern in patterns:
            images = read_set(data_root / name / pattern)
            if images:
                out[name] = images[:limit] if limit else images
                break
    return out


def run_denoise_parity(ours, ref, sets, noise_types) -> int:
    from ..eval.tables import denoise_synthetic_table

    bad = 0
    for nt in noise_types:
        a = denoise_synthetic_table(ours, sets, nt, log_fn=lambda *_: None)
        b = denoise_synthetic_table(ref, sets, nt, log_fn=lambda *_: None)
        bad += _delta_table(
            f"{ours.task} / {nt} (Tables 1-2 protocol)",
            [(f"{ds}/{case}", a[ds][case], b[ds][case])
             for ds in a for case in a[ds]])
    return bad


def run_sisr_parity(ours, ref, sets, nlevel: float = 2.55) -> int:
    from ..eval.tables import sisr_synthetic_table

    a, b = (sisr_synthetic_table(r, sets, ours.sf, nlevel=nlevel,
                                 use_lpips=False, log_fn=lambda *_: None)
            for r in (ours, ref))
    rows = []
    for ds in a:
        for i, (ka, kb) in enumerate(zip(a[ds]["per_kernel"],
                                         b[ds]["per_kernel"])):
            rows.append((f"{ds}/kernel{i + 1}", ka, kb))
        rows.append((f"{ds}/mean", a[ds], b[ds]))
    return _delta_table(f"sisr x{ours.sf} nlevel={nlevel} (Table 5 "
                        f"protocol)", rows)


def run_sidd_parity(ours, ref, sidd_dir: Path) -> int:
    from ..eval.tables import eval_sidd

    noisy = sidd_dir / "ValidationNoisyBlocksSrgb.mat"
    gt = sidd_dir / "ValidationGtBlocksSrgb.mat"
    if not noisy.exists():
        print(f"(SIDD parity skipped: {noisy} not found)")
        return 0
    a, b = (eval_sidd(r, str(noisy), str(gt), log_fn=lambda *_: None)
            for r in (ours, ref))
    return _delta_table("denoising-real / SIDD (Table 4 protocol)",
                        [("SIDD-val", a, b)])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="all",
                   choices=["all", "denoising-syn", "denoising-real",
                            "sisr"])
    p.add_argument("--ref_dir", required=True, type=str,
                   help="the reference checkout (holds networks/)")
    p.add_argument("--ckpt_path", type=str, default="",
                   help="released .pth (default: model_zoo/<task>.pth)")
    p.add_argument("--sf", type=int, default=4, choices=[2, 3, 4])
    p.add_argument("--data_root", type=str, default="",
                   help="eval sets (default: <ref_dir>/test_data)")
    p.add_argument("--sidd_dir", type=str, default="",
                   help="dir holding the SIDD validation .mat pair")
    p.add_argument("--limit", type=int, default=0,
                   help="use only the first N images per set (0 = all)")
    p.add_argument("--noise_types", type=str, default="niid,iid",
                   help="comma list for the denoising tables")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, for both implementations")
    args = p.parse_args(argv)

    from ..eval.engine import Restorer

    data_root = Path(args.data_root or Path(args.ref_dir) / "test_data")
    tasks = [args.task] if args.task != "all" else list(ZOO)
    total_bad = ran = 0
    for task in tasks:
        ckpt = (args.ckpt_path if args.task != "all" and args.ckpt_path
                else ZOO[task].format(sf=args.sf))
        if not Path(ckpt).exists():
            print(f"({task} skipped: checkpoint {ckpt} not found)")
            continue
        ran += 1
        ours = Restorer(task, ckpt_path=ckpt, sf=args.sf, device=args.device)
        ref = ReferenceRestorer(task, ckpt, args.ref_dir, sf=args.sf,
                                device=args.device)
        if task == "sisr":
            sets = _sets(data_root, {"Set14": ["*.bmp"],
                                     "CBSD68": ["*.png"]}, args.limit)
            total_bad += run_sisr_parity(ours, ref, sets)
            continue
        sets = _sets(data_root, {"CBSD68": ["*.png"],
                                 "McMaster": ["*.tif", "*.png"]},
                     args.limit)
        total_bad += run_denoise_parity(ours, ref, sets,
                                        tuple(args.noise_types.split(",")))
        if task == "denoising-real" and args.sidd_dir:
            total_bad += run_sidd_parity(ours, ref, Path(args.sidd_dir))
    if ran == 0:
        print("no checkpoints found — nothing compared")
        return 2
    print(f"\n{'PASS' if total_bad == 0 else 'FAIL'}: {total_bad} case(s) "
          f"outside the ±0.01 dB goal")
    return 0 if total_bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
