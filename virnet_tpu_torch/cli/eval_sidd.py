"""Table 4 SIDD command line (counterpart of virnet_tpu/cli/eval_sidd.py;
reference scripts/denoising_virnet_real_sidd.py).

    python -m virnet_tpu_torch.cli.eval_sidd --sidd_dir <dir> \
        [--test] [--no_flip] [--batch 16] [--device_metrics] \
        [--compute fp32|bf16|int8] [--mesh] [--device cuda|cpu] \
        --ckpt_path ... --save_dir ./results

Validation mode scores PSNR/SSIM against the GT blocks; --test mode
denoises the benchmark blocks for submission.  The x8 flip ensemble runs
as one batched forward per block chunk (8 x --batch blocks), and megatime
(s per restored 1024^2 MP, forward time only) is reported either way.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..eval.engine import Restorer
from ..eval.tables import load_sidd_blocks, sidd_table
from ..train.logging import make_log
from .common import add_eval_args, eval_mesh, log_model_size


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_path", type=str,
                   default="model_zoo/virnet_denoising_real.pth")
    p.add_argument("--sidd_dir", type=str, required=True)
    p.add_argument("--test", action="store_true",
                   help="benchmark blocks (no GT) instead of validation")
    p.add_argument("--no_flip", action="store_true",
                   help="disable the x8 flip ensemble")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device_metrics", action="store_true",
                   help="score PSNR/SSIM on the device (the host protocol "
                        "within ~1e-3 dB; much faster)")
    p.add_argument("--save_dir", type=str, default="")
    add_eval_args(p)
    args = p.parse_args(argv)

    import scipy.io as sio

    flip = not args.no_flip
    test_str = "test" if args.test else "val"
    flip_str = "flip" if flip else "noflip"
    if args.save_dir:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    logger = make_log(Path(args.save_dir) / f"sidd_{test_str}_{flip_str}.log"
                      if args.save_dir else None)
    restorer = Restorer("denoising-real", ckpt_path=args.ckpt_path,
                        compute=args.compute, device=args.device,
                        mesh=eval_mesh(args, logger))
    log_model_size(logger, restorer, sizes=(512,))

    sidd = Path(args.sidd_dir)
    if args.test:
        noisy = load_sidd_blocks(sidd / "BenchmarkNoisyBlocksSrgb.mat",
                                 "BenchmarkNoisyBlocksSrgb")
        gt = None
    else:
        noisy = load_sidd_blocks(sidd / "ValidationNoisyBlocksSrgb.mat",
                                 "ValidationNoisyBlocksSrgb")
        gt = load_sidd_blocks(sidd / "ValidationGtBlocksSrgb.mat",
                              "ValidationGtBlocksSrgb")
    num_im, num_blk, h, w, c = noisy.shape
    res = sidd_table(restorer, noisy.reshape(-1, h, w, c),
                     None if gt is None else gt.reshape(-1, h, w, c),
                     flip_tta=flip, batch=args.batch,
                     device_metrics=args.device_metrics, log_fn=logger.info)

    logger.info(f"megatime: {res['megatime']:.4f} s/MP")
    if gt is not None:
        logger.info(f"PSNR={res['psnr']:.4f}, SSIM={res['ssim']:.4f}")
    if args.save_dir:
        out_path = Path(args.save_dir) / f"sidd_{test_str}_{flip_str}.mat"
        sio.savemat(str(out_path), {
            "denoised_res": res["blocks"].reshape(num_im, num_blk, h, w, c),
            "megatime": res["megatime"]})
        logger.info(f"saved {out_path}")
    return res


if __name__ == "__main__":
    main()
