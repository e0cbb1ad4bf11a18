"""Demo CLI for the denoising tasks (counterpart of
virnet_tpu/cli/demo.py; reference scripts/testing_demo.py:99-135):

    python -m virnet_tpu_torch.cli.demo --task {denoising-syn,denoising-real}
        --in_path <file-or-dir> --out_path <dir> [--ckpt_path <pth>]
        [--prefix restored_] [--flip] [--compute fp32|bf16]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
DEFAULT_CKPTS = {
    "denoising-syn": "model_zoo/virnet_denoising_syn_demo.pth",
    "denoising-real": "model_zoo/virnet_denoising_real_demo.pth",
}


def collect_images(in_path: Path):
    if in_path.is_dir():
        return sorted(p for p in in_path.iterdir()
                      if p.suffix.lower() in IMG_EXTS)
    return [in_path]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--task", required=True, choices=sorted(DEFAULT_CKPTS))
    parser.add_argument("--in_path", required=True, type=str)
    parser.add_argument("--out_path", type=str, default="./results")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="reference .pth checkpoint (default: the "
                             "task's demo weights under model_zoo/)")
    parser.add_argument("--prefix", type=str, default="restored_")
    parser.add_argument("--flip", action="store_true",
                        help="x8 flip/rotation self-ensemble")
    parser.add_argument("--compute", type=str, default="fp32",
                        choices=["fp32", "bf16"],
                        help="fp32 (default) = checkpoint-faithful; "
                             "bf16 = fast path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) runs the CUDA kernels; cpu "
                             "runs their plain PyTorch versions")
    args = parser.parse_args(argv)

    from ..eval.engine import Restorer
    from ..ops.color import imread, imwrite
    from ..ops.quant import img_as_ubyte

    ckpt = args.ckpt_path or DEFAULT_CKPTS[args.task]
    if not Path(ckpt).exists():
        raise SystemExit(f"checkpoint not found: {ckpt}")
    restorer = Restorer(args.task, ckpt_path=ckpt, compute=args.compute,
                        device=args.device)
    out_dir = Path(args.out_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    for im_path in collect_images(Path(args.in_path)):
        im = imread(im_path, chn="rgb", dtype="float32")
        restored = (restorer.restore_image_tta(im) if args.flip
                    else restorer.restore_image(im))
        out_file = out_dir / f"{args.prefix}{im_path.stem}.png"
        imwrite(img_as_ubyte(np.clip(restored, 0.0, 1.0)), out_file,
                chn="rgb")
        print(f"{im_path.name} -> {out_file}")


if __name__ == "__main__":
    main()
