"""The generator: shapes, ranges, and the same inputs from the same seed
(seeds beyond 32 bits included)."""

import json
from pathlib import Path

import pytest
import torch

from portbench.core import generate

REPO = Path(__file__).resolve().parents[2]
TRAFFIC = REPO / "portbench" / "traffic"
TRAIN = json.loads((REPO / "portbench/configs/sisr_x4.json").read_text())[
    "train"]
CPU = torch.device("cpu")


def small(name, **kw):
    spec = json.loads((TRAFFIC / f"{name}.json").read_text())
    spec.update(kw)
    return spec


@pytest.mark.parametrize("name", ["serve_batch_bf16", "serve_image_fp32"])
def test_request_pools(name):
    spec = small(name, pool=2, batch=min(2, small(name)["batch"]))
    spec["shapes"] = [[h // 8, w // 8] for h, w in spec["shapes"]]
    pools = generate.request_images(spec, 2 ** 31 + 11, CPU)
    assert list(pools) == [tuple(s) for s in spec["shapes"]]
    for (h, w), p in pools.items():
        assert p.shape == (2, spec["batch"], h, w, 3) and p.dtype == "float32"
        # noise up to 75/255 spreads the [0, 1] images by some sigma
        assert -2.0 < p.min() and p.max() < 3.0 and p.std() > 0.05
    again = generate.request_images(spec, 2 ** 31 + 11, CPU)
    other = generate.request_images(spec, 2 ** 31 + 12, CPU)
    for k in pools:
        assert (pools[k] == again[k]).all()
        assert not (pools[k] == other[k]).all()


def test_clean_images_lie_in_range():
    g = generate.generator(3, CPU)
    im = generate.photo_images(g, 3, 20, 30, CPU)
    assert im.shape == (3, 20, 30, 3)
    assert im.min() >= 0 and im.max() <= 1


def test_records_and_step_draws():
    spec = small("train_bf16", records=3, record_size=64, draw_sets=2)
    train = dict(TRAIN, batch_size=4, hr_size=48)
    rec = generate.records(spec, 7, CPU)
    assert rec.shape == (3, 64, 64, 3) and rec.dtype == torch.uint8
    draws = generate.sisr_step_draws(spec, train, 7, CPU)
    assert len(draws) == 2
    d = draws[0]
    assert d["sample"]["idx"].max() < 3 and d["sample"]["mode"].max() < 8
    assert d["sample"]["oh"].max() <= 64 - 48
    assert d["synth"]["noise"].shape == (4, 12, 12, 3)
    assert d["elbo"]["z_eps"].shape == (4, 48, 48, 3)
    assert d["elbo"]["gamma_draw"].shape == (4, 2)
    lo, hi = TRAIN["noise_level"]
    assert (d["synth"]["nlevel"] >= lo / 255).all()
    assert (d["synth"]["nlevel"] <= hi / 255).all()
    assert not torch.equal(draws[0]["elbo"]["z_eps"],
                           draws[1]["elbo"]["z_eps"])
    again = generate.sisr_step_draws(spec, train, 7, CPU)
    assert torch.equal(again[1]["synth"]["noise"], draws[1]["synth"]["noise"])
