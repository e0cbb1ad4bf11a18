"""SISR serving in the port (eval/engine.py:Restorer(task='sisr'), the
demo CLI's sisr task) against the JAX package's Restorer, on the CPU in
fp32, with the x2, x3 and x4 demo weights of model_zoo/."""

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.eval.engine import Restorer as JaxRestorer
from virnet_tpu.eval.tiling import forward_chop as jax_forward_chop
from virnet_tpu_torch.eval.engine import CHOP_THRESHOLD, Restorer
from virnet_tpu_torch.eval.tiling import forward_chop
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _ckpt(sf):
    return str(ROOT / "model_zoo" / f"virnet_sisr_x{sf}_demo.pth")


@pytest.fixture(scope="module", params=[2, 3, 4])
def restorers(request):
    sf = request.param
    return sf, (JaxRestorer("sisr", ckpt_path=_ckpt(sf), sf=sf),
                Restorer("sisr", ckpt_path=_ckpt(sf), sf=sf, device="cpu"))


@pytest.fixture(scope="module")
def x2():
    return (JaxRestorer("sisr", ckpt_path=_ckpt(2), sf=2),
            Restorer("sisr", ckpt_path=_ckpt(2), sf=2, device="cpu"))


def _im(seed, h, w):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


@pytest.mark.parametrize("hw", [(24, 24), (23, 29)])
def test_restore_image_matches_jax(restorers, hw):
    """mu atol 1e-5 (ROADMAP's fp32 bar): the same function, sums in
    another order; (23, 29) runs RNet's reflect pad."""
    sf, (jr, tr) = restorers
    im = _im(sf, *hw)
    got = tr.restore_image(im)
    assert got.shape == (hw[0] * sf, hw[1] * sf, 3)
    np.testing.assert_allclose(got, jr.restore_image(im), atol=1e-5)


def test_tta_and_restore_images_match_jax(x2):
    """x2: the x8 ensemble (two orientation groups at 14x18) and folder
    mode (two shapes, a gray image) at mu atol 1e-5."""
    jr, tr = x2
    im = _im(5, 14, 18)
    np.testing.assert_allclose(tr.restore_image_tta(im),
                               jr.restore_image_tta(im), atol=1e-5)
    ims = [_im(6, 14, 18), _im(7, 17, 13), _im(8, 14, 18)[..., 0]]
    for a, b in zip(tr.restore_images(ims, batch_size=2),
                    jr.restore_images(ims, batch_size=2)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_im2col_route_matches_jax(x2):
    """The route fp32 serving takes on the card (``Restorer.im2col``: every
    library convolution of RNet and KNet through PyTorch's im2col ops, run
    here on the CPU) computes the same function: mu atol 1e-5 against the
    JAX Restorer at an odd size, and the im2col ops did run."""
    from torch.profiler import ProfilerActivity, profile

    jr, tr = x2
    im = _im(9, 23, 29)
    tr.im2col = True
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = tr.restore_image(im)
    finally:
        tr.im2col = False
    ops = {e.key for e in prof.key_averages()}
    assert {"aten::thnn_conv2d", "aten::slow_conv_transpose2d"} <= ops
    np.testing.assert_allclose(got, jr.restore_image(im), atol=1e-5)


def test_forward_chop_at_sf_matches_jax(x2):
    """forward_chop with sf = 2 on the x2 model's forward at a small
    min_size (the quadrant tiling of an image above CHOP_THRESHOLD, at a
    size the JAX side runs quickly on the CPU): mu atol 1e-5."""
    jr, tr = x2
    x = _im(9, 40, 46)[None]
    want = jax_forward_chop(jr.restore_batch, jnp.asarray(x), sf=2, shave=4,
                            min_size=500)
    got = forward_chop(tr.restore_batch, torch.from_numpy(x), sf=2, shave=4,
                       min_size=500)
    assert got.shape == (1, 80, 92, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_restore_image_chops_above_the_threshold(x2, monkeypatch):
    """restore_image takes the tiled path above CHOP_THRESHOLD and scales
    every crop by sf: with the threshold lowered to 600 pixels (tiles of
    25x27, then 22x23), the x2 output equals forward_chop on the same
    forward exactly."""
    import virnet_tpu_torch.eval.engine as engine

    tr = x2[1]
    im = _im(10, 30, 34)
    want = forward_chop(tr.restore_batch, torch.from_numpy(im[None]), sf=2,
                        shave=10, min_size=600)[0].numpy()
    monkeypatch.setattr(engine, "CHOP_THRESHOLD", 600)
    got = tr.restore_image(im)
    assert got.shape == (60, 68, 3) and CHOP_THRESHOLD == 160000
    np.testing.assert_array_equal(got, want)


def test_demo_cli_sisr_writes_the_upscaled_image(tmp_path):
    """The demo's sisr task writes the x{sf} image, equal to Restorer's
    uint8 round trip (default weights: the task's demo checkpoint)."""
    from virnet_tpu_torch.cli.demo import main

    im = (_im(11, 15, 19) * 255).round().astype(np.uint8)
    src = tmp_path / "lr.png"
    cv2.imwrite(str(src), im)
    main(["--task", "sisr", "--sf", "3", "--in_path", str(src),
          "--out_path", str(tmp_path / "out"), "--device", "cpu",
          "--ckpt_path", _ckpt(3)])
    out = cv2.imread(str(tmp_path / "out" / "restored_lr.png"))
    assert out is not None and out.shape == (45, 57, 3)
    rgb = cv2.cvtColor(im, cv2.COLOR_BGR2RGB).astype(np.float32) / 255
    want = Restorer("sisr", ckpt_path=_ckpt(3), sf=3, device="cpu") \
        .restore_image(rgb)
    want = np.rint(np.clip(want, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(cv2.cvtColor(out, cv2.COLOR_BGR2RGB),
                                  want)
