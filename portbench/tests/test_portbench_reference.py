"""The plain reference against the program's plain CPU path at a tiny
size: the released weights through the Restorer's fp32 forward, and three
fp32 SISR training steps from the same weights, records and draws."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.core import generate
from portbench.reference import models as R
from portbench.reference import sisr_train as RT

REPO = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def config(name):
    path = REPO / "portbench/configs" / f"{name}.json"
    return json.loads(path.read_text())


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,shape", [("denoising_syn", (2, 36, 52)),
                                        ("sisr_x4", (1, 13, 17))])
def test_restore_matches_the_programs_fp32_path(name, shape):
    from virnet_tpu_torch.eval.engine import Restorer

    cfg = config(name)
    x = np.random.default_rng(0).random((*shape, 3)).astype(np.float32)
    r = Restorer(cfg["task"], ckpt_path=REPO / cfg["weights"],
                 sf=cfg["sf"], compute="fp32", device="cpu")
    got = r.restore_batch(x).numpy()
    want = R.restore(torch.from_numpy(x), R.load_state(REPO / cfg["weights"]),
                     cfg["arch"], cfg["sf"]).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


def test_param_specs_are_the_released_files():
    for name in ("denoising_syn", "sisr_x4"):
        cfg = config(name)
        sd = R.load_state(REPO / cfg["weights"])
        specs = R.param_specs(cfg["arch"])
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: s for k, s, _ in specs}


def test_dihedral_is_the_programs():
    from virnet_tpu_torch.data.device_data import dihedral_traced

    x = torch.arange(5 * 5 * 2).view(5, 5, 2)
    for m in range(8):
        assert torch.equal(RT.dihedral(x, m),
                           dihedral_traced(x[None], torch.tensor([m]))[0])


def test_bicubic_is_the_programs():
    from virnet_tpu_torch.ops.resize import resize_nhwc

    x = torch.rand(2, 48, 40, 3, dtype=torch.float64)
    got = resize_nhwc(x, scale_factors=0.25)
    want = RT.bicubic_down(x.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
    assert torch.allclose(got, want, atol=1e-12)


def test_three_training_steps_match_the_programs_fp32_steps(tmp_path):
    from virnet_tpu_torch.data.device_data import DeviceDataset
    from virnet_tpu_torch.train.loop_sisr import (SISRTrainConfig,
                                                  SISRTrainer)

    cfg = config("sisr_x4")
    arch = dict(cfg["arch"], n_feat=[16, 32, 48], dep_K=2, n_resblocks=1)
    train = dict(cfg["train"], batch_size=2, hr_size=48,
                 mixed_precision=False)
    spec = dict(records=4, record_size=64, draw_sets=3)
    recs = generate.records(spec, 7, CPU)
    draws = generate.sisr_step_draws(spec, train, 7, CPU)
    params = R.seeded_params(arch, 7, CPU)
    fields = SISRTrainConfig.__dataclass_fields__
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in {**arch, **train}.items() if k in fields}
    tr = SISRTrainer(SISRTrainConfig(**kw, save_dir=str(tmp_path)),
                     device="cpu")
    tr.model.load_state_dict(params, strict=True)
    ds = DeviceDataset(recs.numpy(), device="cpu")
    losses = []
    for t, d in enumerate(draws):
        losses.append(float(tr.run_step_device(ds, 0, noise=d)["loss"]))
        if t == 0:
            g1 = {n: tr.optim.adam.state[p]["exp_avg"] / 0.1
                  for n, p in tr.model.named_parameters()}
    ref = RT.train_steps(params, recs, draws, train, arch)
    assert losses == pytest.approx(ref["loss"], rel=1e-6)
    for k, p in tr.model.named_parameters():
        assert torch.allclose(g1[k], ref["grad1"][k], rtol=1e-3,
                              atol=1e-5 * float(ref["grad1"][k].abs().max()))
        assert torch.allclose(p.detach(), ref["params"][k], atol=1e-7)
