"""Table 5 command line (counterpart of virnet_tpu/cli/eval_sisr.py;
reference scripts/sisr_virnet_syn.py).

    python -m virnet_tpu_torch.cli.eval_sisr --sf 4 --nlevel 2.55 \
        --data_root <dir with Set14/*.bmp, CBSD68/*.png> \
        --ckpt_path model_zoo/virnet_sisr_x4.pth --save_dir ./results \
        [--compute fp32|bf16|int8] [--mesh] [--device cuda|cpu]

LPIPS (eval/lpips.py) needs the pretrained weights file: set
VIRNET_LPIPS_WEIGHTS (or drop model_zoo/lpips_alex.pth), or pass
--lpips_weights, and it is scored automatically; --lpips {auto,on,off}
overrides.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

from ..eval import lpips as lpips_mod
from ..eval.engine import Restorer
from ..eval.tables import eval_sisr_synthetic
from ..train.logging import make_log
from .common import add_eval_args, eval_mesh, log_model_size


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_path", type=str, default="",
                   help="default model_zoo/virnet_sisr_x{sf}.pth")
    p.add_argument("--sf", type=int, default=4, choices=[2, 3, 4])
    p.add_argument("--nlevel", type=float, default=0.0)
    p.add_argument("--save_dir", type=str, default="")
    p.add_argument("--data_root", type=str, required=True,
                   help="folder holding Set14/*.bmp and CBSD68/*.png")
    p.add_argument("--downsampler", type=str, default="bicubic")
    p.add_argument("--lpips", type=str, default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--lpips_weights", type=str, default="",
                   help="torch lpips-alex checkpoint path (either format "
                        "in eval/lpips.py); overrides "
                        "VIRNET_LPIPS_WEIGHTS / model_zoo/lpips_alex.pth")
    p.add_argument("--pad_multiple", type=int, default=0,
                   help="0 (default) = reference-exact raw forwards; >0 "
                        "reflect-pads to size buckets (small edge drift)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="images per forward within an LR-shape group")
    add_eval_args(p)
    args = p.parse_args(argv)

    ckpt = args.ckpt_path or str(Path("model_zoo")
                                 / f"virnet_sisr_x{args.sf}.pth")
    nl_str = (str(int(args.nlevel)) if args.nlevel == 0
              else str(args.nlevel).replace(".", ""))
    if args.save_dir:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    logger = make_log(Path(args.save_dir)
                      / f"sisr_sf{args.sf}_nl{nl_str}.log"
                      if args.save_dir else None)
    restorer = Restorer("sisr", ckpt_path=ckpt, sf=args.sf,
                        pad_multiple=args.pad_multiple, compute=args.compute,
                        device=args.device,
                        mesh=eval_mesh(args, logger))
    log_model_size(logger, restorer)

    data_dirs = {
        "Set14": str(Path(args.data_root) / "Set14" / "*.bmp"),
        "CBSD68": str(Path(args.data_root) / "CBSD68" / "*.png"),
    }
    use_lpips = {"auto": None, "on": True, "off": False}[args.lpips]
    if args.lpips_weights:
        lpips_mod.set_params(lpips_mod.load_lpips_params(args.lpips_weights))
    results = eval_sisr_synthetic(restorer, data_dirs, args.sf,
                                  nlevel=args.nlevel,
                                  downsampler=args.downsampler,
                                  use_lpips=use_lpips,
                                  batch_size=args.batch_size,
                                  log_fn=logger.info)
    if args.save_dir:
        out = Path(args.save_dir) / f"sisr_sf{args.sf}_nl{nl_str}.pkl"
        with open(out, "wb") as f:
            pickle.dump(results, f)
        logger.info(f"saved {out}")
    return results


if __name__ == "__main__":
    main()
