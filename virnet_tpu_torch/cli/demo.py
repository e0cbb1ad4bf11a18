"""Demo CLI (counterpart of virnet_tpu/cli/demo.py; reference
scripts/testing_demo.py:99-135):

    python -m virnet_tpu_torch.cli.demo
        --task {denoising-syn,denoising-real,sisr} --in_path <file-or-dir>
        --out_path <dir> [--sf {2,3,4}] [--ckpt_path <pth>]
        [--prefix restored_] [--flip] [--compute fp32|bf16|int8]
        [--mesh [--batch_size 8] | --rows_shard] [--device cuda|cpu]

``sisr`` writes each image ``--sf`` times larger; its default weights are
``model_zoo/virnet_sisr_x{sf}_demo.pth``.  ``--mesh`` restores a folder's
same-shape images in batches split over every visible card (and the x8
ensemble of ``--flip`` over them); ``--rows_shard`` splits each image's
rows over every visible card (eval/spatial.py), for huge images, in fp32
whatever ``--compute`` is (as the JAX demo's sharded stages run).  Both
give what the plain path gives, up to summation order.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
DEFAULT_CKPTS = {
    "denoising-syn": "model_zoo/virnet_denoising_syn_demo.pth",
    "denoising-real": "model_zoo/virnet_denoising_real_demo.pth",
    "sisr": "model_zoo/virnet_sisr_x{sf}_demo.pth",
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
    parser.add_argument("--sf", type=int, default=2, choices=[2, 3, 4],
                        help="SISR scale factor")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="reference .pth checkpoint (default: the "
                             "task's demo weights under model_zoo/)")
    parser.add_argument("--prefix", type=str, default="restored_")
    parser.add_argument("--flip", action="store_true",
                        help="x8 flip/rotation self-ensemble")
    parser.add_argument("--compute", type=str, default="fp32",
                        choices=["fp32", "bf16", "int8"],
                        help="fp32 (default) = checkpoint-faithful; "
                             "bf16 = fast path; int8 = W8A8 serving (not "
                             "checkpoint-faithful)")
    parser.add_argument("--rows_shard", action="store_true",
                        help="shard each image's rows over every visible "
                             "card (huge images; matches the plain fp32 "
                             "forward, in every --compute)")
    parser.add_argument("--mesh", action="store_true",
                        help="data-parallel inference over every visible "
                             "card: folder batches and the x8 --flip "
                             "ensemble split over them")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="images per forward in folder mode with "
                             "--mesh (same-shape images are grouped)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) runs the CUDA kernels; cpu "
                             "runs their plain PyTorch versions")
    args = parser.parse_args(argv)

    from ..eval.engine import Restorer
    from ..ops.color import imread, imwrite
    from ..ops.quant import img_as_ubyte

    from ..train.mesh import make_mesh

    if args.rows_shard and args.flip:
        raise SystemExit("--rows_shard and --flip are mutually exclusive "
                         "(run the x8 ensemble unsharded, or shard without "
                         "the ensemble)")
    if args.rows_shard and args.mesh:
        raise SystemExit("--rows_shard already uses every card (the rows "
                         "axis); --mesh is the data-parallel alternative")
    ckpt = args.ckpt_path or DEFAULT_CKPTS[args.task].format(sf=args.sf)
    if not Path(ckpt).exists():
        raise SystemExit(f"checkpoint not found: {ckpt}")
    mesh = None
    if args.mesh or args.rows_shard:
        cpu = torch.device(args.device).type == "cpu"
        mesh = make_mesh([args.device] if cpu else None)
    restorer = Restorer(args.task, ckpt_path=ckpt, sf=args.sf,
                        compute=args.compute, device=args.device,
                        mesh=mesh if args.mesh else None)
    out_dir = Path(args.out_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    im_paths = collect_images(Path(args.in_path))

    def write(im_path, restored):
        out_file = out_dir / f"{args.prefix}{im_path.stem}.png"
        imwrite(img_as_ubyte(np.clip(restored, 0.0, 1.0)), out_file,
                chn="rgb")
        print(f"{im_path.name} -> {out_file}")

    if args.mesh and not args.flip:
        # folder mode: same-shape images batched and split over the mesh
        ims = [imread(p, chn="rgb", dtype="float32") for p in im_paths]
        for im_path, restored in zip(
                im_paths, restorer.restore_images(ims, args.batch_size)):
            write(im_path, restored)
        return
    for im_path in im_paths:
        im = imread(im_path, chn="rgb", dtype="float32")
        if args.rows_shard:
            restored = restorer.restore_image_sharded(im, mesh)
        elif args.flip:
            restored = restorer.restore_image_tta(im)
        else:
            restored = restorer.restore_image(im)
        write(im_path, restored)


if __name__ == "__main__":
    main()
