"""Export a trainer run of the port to a reference-loadable .pth
(counterpart of virnet_tpu/cli/export_torch.py):

    python -m virnet_tpu_torch.cli.export_torch --task denoising-syn \
        --run_dir ./train_save --out model.pth [--step N]

``--run_dir`` is a trainer's ``--save_dir`` (it holds ``ckpts/``).  The
file holds {'epoch', 'model_state_dict'} with the reference's keys, so it
loads ``strict=True`` into the reference's networks/VIRNet.py classes, into
``Restorer(ckpt_path=...)`` and through ``convert.load_pth``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", required=True,
                   choices=["denoising-syn", "denoising-real", "sisr"])
    p.add_argument("--run_dir", required=True, type=str,
                   help="trainer save_dir containing ckpts/")
    p.add_argument("--out", required=True, type=str)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    args = p.parse_args(argv)

    from ..convert import save_torch_checkpoint
    from ..models import build_model
    from ..train.checkpoint import CheckpointManager

    if not (Path(args.run_dir) / "ckpts").is_dir():
        raise SystemExit(f"no trainer checkpoints under {args.run_dir} "
                         f"(expected {args.run_dir}/ckpts/)")
    state = CheckpointManager(args.run_dir).restore(args.step)
    if state is None or "params" not in state:
        raise SystemExit(f"no train state under {args.run_dir}")
    # the preset must take the weights as they are before they are written
    build_model(args.task).load_state_dict(state["params"], strict=True)
    epoch = int(state.get("epoch", 0))
    save_torch_checkpoint(args.out, state["params"], epoch=epoch)
    print(f"exported epoch-{epoch} params -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
