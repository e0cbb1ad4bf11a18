"""K11's work (counts/k11.py) against a hand count for both denoising
configurations, its split plans against the program's, and the
real-noise configuration and its photo traffic loaded as a cell."""

from pathlib import Path

import pytest

from portbench.core.cell import Cell, load_module
from portbench.core.device import PEAKS
from portbench.core.roofline import least_s

REPO = Path(__file__).resolve().parents[2]
K11 = load_module(REPO / "portbench/counts/k11.py")
PHOTO = "denoising_real.serve_photo_bf16"


def conv(npx, ci, co_padded, reads, count, shapes=1):
    """(flops, bytes, compute) of ``count`` launches: a hand count."""
    weights = 9 * ci * co_padded + ci
    return (count * 2 * 9 * ci * co_padded * npx / shapes,
            count * 2 * (npx * ci * (reads + 1) + weights) / shapes, "bf16")


@pytest.mark.parametrize("co,want", [
    (96, (96, 1)), (160, (80, 2)), (192, (96, 2)), (224, (112, 2)),
    (288, (96, 3)), (64, (64, 1)), (16, (64, 1))])
def test_plans(co, want):
    assert K11.plan(co) == want


def test_plans_are_the_programs():
    from virnet_tpu_torch.ops.resblock import plan

    for co in range(16, 513, 16):
        assert K11.plan(co) == plan(co, co), co


def test_blocks_a_level():
    syn = Cell.load(REPO, "denoising_syn.serve_batch_bf16").config["arch"]
    real = Cell.load(REPO, PHOTO).config["arch"]
    sr = Cell.load(REPO, "sisr_x4.train_bf16").config["arch"]
    assert K11.blocks(syn) == [6, 6, 3]            # 30 launches a forward
    assert K11.blocks(real) == [6, 6, 6, 3]        # 42
    assert K11.blocks(sr) == [2, 2, 0]             # 8: its up path alone


def test_work_of_the_syn_batch():
    """32 x 256^2: 96 wide at 256^2, 192 (2 x 96) at 128^2, 288 (3 x 96)
    at 64^2, each level's first and second launches."""
    cell = Cell.load(REPO, "denoising_syn.serve_batch_bf16")
    px = [32 * 256 * 256, 32 * 128 * 128, 32 * 64 * 64]
    want = [conv(px[0], 96, 96, 1, 6), conv(px[0], 96, 96, 2, 6),
            conv(px[1], 192, 192, 1, 6), conv(px[1], 192, 192, 2, 6),
            conv(px[2], 288, 288, 1, 3), conv(px[2], 288, 288, 2, 3)]
    assert K11.work(cell) == pytest.approx(want)
    # the kernel table's bounds a block (0.7124, 0.7035, 0.3957 ms)
    least = least_s(K11.work(cell), PEAKS["H100 SXM"])
    assert least * 1e3 == pytest.approx(6 * 0.7124 + 6 * 0.7035
                                        + 3 * 0.3957, rel=1e-3)


def test_work_of_the_photo():
    """One 4032 x 3024 photo a request, either way up: 96 wide at 12.2 MP,
    160 (2 x 80) at a quarter, 224 (2 x 112) at a sixteenth, 288 (3 x 96)
    at a sixty-fourth; the two shapes take turns."""
    cell = Cell.load(REPO, PHOTO)
    px = [3024 * 4032, 1512 * 2016, 756 * 1008, 378 * 504]
    one = []
    for level, (c, count) in enumerate(zip((96, 160, 224, 288),
                                           (6, 6, 6, 3))):
        one += [conv(px[level], c, c, 1, count, 2),
                conv(px[level], c, c, 2, count, 2)]
    assert K11.work(cell) == pytest.approx(one + one)
    # 12 launches of 2.023, 12 of 1.404, 12 of 0.688 and 6 of 0.284 TFLOP
    flops = sum(f for f, _, _ in K11.work(cell))
    assert flops / 1e12 == pytest.approx(51.09, abs=0.01)
    least = least_s(K11.work(cell), PEAKS["H100 SXM"])
    assert 50e-3 < least < 54e-3


def test_padded_levels():
    """RNet pads its input to a multiple of 2^(depth - 1): a 37 x 53
    request is counted at 40 x 56."""
    cell = Cell.load(REPO, PHOTO)
    cell.traffic = dict(cell.traffic, shapes=[[37, 53]])
    work = K11.work(cell)
    assert work[0] == pytest.approx(conv(40 * 56, 96, 96, 1, 6))
    assert work[-1] == pytest.approx(conv(5 * 7, 288, 288, 2, 3))


def test_the_photo_cell_loads():
    cell = Cell.load(REPO, PHOTO)
    assert cell.chips == 1 and cell.config["task"] == "denoising-real"
    assert cell.config["arch"]["n_feat"] == [96, 160, 224, 288]
    assert (REPO / cell.config["weights"]).is_file()
    t = cell.traffic
    assert (t["kind"], t["entry"], t["compute"], t["batch"]) == (
        "serve", "restore_batch", "bf16", 1)
    assert t["shapes"] == [[3024, 4032], [4032, 3024]]
    # both sides multiples of 8: K3's fused head takes them
    assert all(s % 8 == 0 for shape in t["shapes"] for s in shape)
    assert set(cell.limits) == {"gap_pool8", "gap_max"}
    assert cell.check["controls"] == ["ref_fp8"]
    assert [m["name"] for m in cell.end_to_end] == ["restore_mp_per_s",
                                                    "setup_s"]
    layer = {m["name"] for m in cell.per_layer}
    assert {"k11_roofline", "k3_roofline", "k4_roofline", "mfu.serve",
            "rnet_deep_card_ms.serve", "rnet_card_ms.serve",
            "own_launches.serve"} <= layer
    for name in layer:
        assert (REPO / "portbench/metrics" / f"{name}.py").is_file()
