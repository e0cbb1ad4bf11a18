"""Table 1/2 command line (counterpart of virnet_tpu/cli/eval_denoising_syn.py;
reference scripts/denoising_virnet_syn.py).

    python -m virnet_tpu_torch.cli.eval_denoising_syn --noise_type niid \
        --data_root <dir with CBSD68/*.png, McMaster/*.tif> \
        --ckpt_path model_zoo/virnet_denoising_syn.pth --save_dir ./results \
        [--compute fp32|bf16|int8] [--mesh] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

from ..eval.engine import Restorer
from ..eval.tables import eval_denoise_synthetic
from ..train.logging import make_log
from .common import add_eval_args, eval_mesh, log_model_size


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_path", type=str,
                   default="model_zoo/virnet_denoising_syn.pth")
    p.add_argument("--noise_type", type=str, default="niid",
                   choices=["niid", "iid"])
    p.add_argument("--save_dir", type=str, default="")
    p.add_argument("--data_root", type=str, required=True,
                   help="folder holding CBSD68/*.png and McMaster/*.tif")
    p.add_argument("--pad_multiple", type=int, default=0,
                   help="0 (default) = reference-exact raw forwards; >0 "
                        "reflect-pads to size buckets (small edge drift)")
    add_eval_args(p)
    args = p.parse_args(argv)

    if args.save_dir:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    logger = make_log(Path(args.save_dir) / f"denoise_{args.noise_type}.log"
                      if args.save_dir else None)
    restorer = Restorer("denoising-syn", ckpt_path=args.ckpt_path,
                        pad_multiple=args.pad_multiple, compute=args.compute,
                        device=args.device,
                        mesh=eval_mesh(args, logger))
    log_model_size(logger, restorer)

    data_dirs = {
        "CBSD68": str(Path(args.data_root) / "CBSD68" / "*.png"),
        "McMaster": str(Path(args.data_root) / "McMaster" / "*.tif"),
    }
    results = eval_denoise_synthetic(restorer, data_dirs, args.noise_type,
                                     log_fn=logger.info)
    if args.save_dir:
        out = Path(args.save_dir) / f"results_{args.noise_type}.pkl"
        with open(out, "wb") as f:
            pickle.dump(results, f)
        logger.info(f"saved {out}")
    return results


if __name__ == "__main__":
    main()
