"""The harness's arithmetic on the CPU: model FLOPs, the rooflines, the
trace's busy and idle time on a synthetic kernel list, and the gaps that
decide ``correct``."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.core import judge, roofline
from portbench.core.cell import Cell, load_module
from portbench.core.device import PEAKS
from portbench.core.flops import forward_flops
from portbench.core.trace import Trace, kind

REPO = Path(__file__).resolve().parents[2]
SYN = json.loads((REPO / "portbench/configs/denoising_syn.json").read_text())
SR = json.loads((REPO / "portbench/configs/sisr_x4.json").read_text())


def test_denoising_syn_is_4_99_tflop_a_megapixel():
    # BASELINE.md: 163.5 GMACs = 326.9 GFLOPs a 256^2 forward (thop)
    flops = forward_flops(SYN["arch"], 1, 256, 256)
    assert flops / 1e9 == pytest.approx(326.94, abs=0.01)
    assert flops / (256 * 256 / 1e6) / 1e12 == pytest.approx(4.99, abs=0.005)


def test_flops_scale_with_the_batch_and_the_sisr_step():
    one = forward_flops(SR["arch"], 1, 48, 48, 4)
    assert forward_flops(SR["arch"], 16, 48, 48, 4) == pytest.approx(16 * one)
    assert 1.5e12 < 16 * one < 1.65e12


@pytest.mark.parametrize("name,want", [
    ("void dncnn_head_bf16_kernel<3,1>(Args)", "ours"),
    ("tail_kernel<bf16>", "ours"),
    ("conv3x3_mid_f32_kernel", "ours"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "library"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel", "library"),
    ("ampere_sgemm_128x64_nn", "library"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::im2col_kernel<float>", "elementwise"),
])
def test_kernel_kinds(name, want):
    assert kind(name) == want


def synthetic_trace():
    # two calls: K4 2 ms, an elementwise pass 1 ms, a copy 0.5 ms, with a
    # 0.5 ms gap the host spends in aten::copy_ and one in aten::add
    ops = [("tail_kernel", 0, 2000), ("elementwise_kernel", 2000, 3000),
           ("Memcpy DtoH (Device -> Pageable)", 3500, 4000),
           ("tail_kernel", 4000, 6000), ("elementwise_kernel", 6500, 7500)]
    host = [("restore", 0, 8000), ("aten::copy_", 3000, 3500),
            ("aten::add", 6000, 6500)]
    return Trace(ops, host, units=2, window_s=0.010)


def test_busy_idle_and_breakdown():
    t = synthetic_trace()
    assert t.busy_s == pytest.approx(0.0065)
    assert t.ms_per_unit(lambda n: kind(n) == "elementwise") == 1.0
    assert t.ms_per_unit(lambda n: "tail_kernel" in n) == 2.0
    b = t.breakdown()
    assert b["device_ops"][0] == ["tail_kernel", pytest.approx(0.004)]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "aten::copy_": pytest.approx(0.0005),
        "aten::add": pytest.approx(0.0005)}
    # 6.5 ms busy in the traced window of 10 ms
    ctx = SimpleNamespace(trace=t, device=torch.device("cuda"))
    for name in ("device_idle.serve", "device_idle.train"):
        idle = load_module(REPO / f"portbench/metrics/{name}.py")
        assert idle.read(ctx) == pytest.approx(100 * (1 - 6.5 / 10.0))


def test_roofline_share_of_k4():
    cell = Cell.load(REPO, "denoising_syn.serve_batch_bf16")
    t = synthetic_trace()
    ctx = SimpleNamespace(trace=t, device=torch.device("cuda"), cell=cell,
                          peaks=PEAKS["H100 SXM"],
                          counts=lambda k: load_module(
                              REPO / "portbench/counts" / f"{k}.py"))
    npx = 32 * 256 * 256
    nbytes = npx * 96 * 2 + npx * 24 + (9 * 96 * 3 + 3) * 2
    least = max(2 * 9 * 96 * 3 * npx / 989e12, nbytes / 3.35e12)
    assert least == pytest.approx(0.1352e-3, rel=1e-3)    # chip_smoke's bound
    assert roofline.share(ctx, "k4") == pytest.approx(100 * least / 2e-3)
    assert roofline.share(ctx, "k3") is None              # no K3 in the trace
    ctx.device = torch.device("cpu")
    assert roofline.share(ctx, "k4") is None


def test_blur_counts_are_the_smoke_runs():
    cell = Cell.load(REPO, "sisr_x4.train_bf16")
    work = load_module(REPO / "portbench/counts/blur.py").work(cell)
    assert len(work) == 4
    # each blur at 16 x 192^2 x 3, k = 21: 0.0233 ms at the f32 peak
    assert all(max(f / 67e12, b / 3.35e12) == pytest.approx(0.0233e-3,
                                                            rel=0.01)
               for f, b, _ in work)


def test_image_gaps_and_verdict():
    a = np.zeros((2, 8, 8, 3), np.float32)
    b = a.copy()
    b[1, 2, 2, 0] = 0.5
    g = judge.image_gaps(a, b)
    assert g["gap_max"] == 0.5
    assert g["gap_rms"] == pytest.approx(0.5 / math.sqrt(2 * 64 * 3))
    assert g["gap_mean"] == pytest.approx(0.5 / 64)
    # image 1's one block: 0.5 / 64 in channel 0 of 3
    assert g["gap_pool8"] == pytest.approx(0.5 / 64 / math.sqrt(3))
    assert judge.image_gaps(a, b[:1])["gap_max"] == math.inf
    ok, rows = judge.verdict(g, {"gap_max": 0.6})
    assert ok and rows == [("gap_max", 0.5, 0.6)]
    assert not judge.verdict(g, {"gap_max": 0.4})[0]
    assert not judge.verdict(g, {"missing": 1.0})[0]
    assert not judge.verdict(g, {})[0]


def test_leaf_gaps():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0),
           "c": torch.full((4,), 1e-9)}
    got = {"a": torch.ones(4) * 1.1, "b": torch.full((4,), 2.0),
           "c": torch.full((4,), 3e-9)}
    gap, leaf = judge.leaf_gap(got, ref)
    # c's own norm is tiny: it is measured against the median leaf's
    assert leaf == "a" and gap == pytest.approx(0.1)
    p0 = {k: torch.zeros(4) for k in ref}
    prog = dict(loss=[1.0], terms=[{"lh": 1.0}], grad1=ref, params=p0)
    refd = dict(loss=[1.0], terms=[{"lh": 1.0}], grad1=ref, params=got)
    out = judge.train_gaps(prog, refd, p0)
    # a state left unchanged reads 1; c (nought to rounding) is left out
    assert out["change_gap"] == pytest.approx(1.0)
    assert out["leaves_left_out"] == 1
