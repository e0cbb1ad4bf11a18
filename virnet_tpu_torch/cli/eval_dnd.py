"""DND submission command line (counterpart of virnet_tpu/cli/eval_dnd.py;
reference scripts/denoising_virnet_real_dnd.py:86-88).

    python -m virnet_tpu_torch.cli.eval_dnd --dnd_dir <dir> \
        --save_dir ./dnd_out --ckpt_path model_zoo/virnet_denoising_real.pth \
        [--no_flip] [--compute fp32|bf16|int8] [--mesh]
        [--device cuda|cpu]

Reads info.mat and images_srgb/ with h5py, which must be installed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..eval.dnd import bundle_submissions_srgb, denoise_srgb, make_denoiser
from ..eval.engine import Restorer
from ..train.logging import make_log
from .common import add_eval_args, eval_mesh


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_path", type=str,
                   default="model_zoo/virnet_denoising_real.pth")
    p.add_argument("--dnd_dir", type=str, required=True,
                   help="folder containing info.mat and images_srgb/")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--no_flip", action="store_true")
    add_eval_args(p)
    args = p.parse_args(argv)

    Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    logger = make_log(Path(args.save_dir) / "dnd.log")
    restorer = Restorer("denoising-real", ckpt_path=args.ckpt_path,
                        compute=args.compute, device=args.device,
                        mesh=eval_mesh(args, logger))
    denoiser = make_denoiser(restorer, flip=not args.no_flip)
    denoise_srgb(denoiser, args.dnd_dir, args.save_dir, log_fn=logger.info)
    bundle_submissions_srgb(args.save_dir)
    logger.info(f"submission bundle written to {args.save_dir}/bundled")


if __name__ == "__main__":
    main()
