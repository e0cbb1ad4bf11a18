"""Metrics, eval sets and the host degradation of the port (eval/metrics.py,
data/eval_sets.py, ops/sigma_fields.py, ops/degrade.py:imconv_np,
degrade_np, ops/color.py, ops/pad.py:modcrop) against the JAX package's,
and the trainers' per-epoch validation, on the CPU.

Both sides of every host-side comparison are numpy (and cv2, scipy and a
torch CPU Generator) on the same seeded inputs, so they are held bit for
bit: assert_array_equal, and == for scores; SSIM within 1e-12, as the
port's filters without cv2 (sums in another order)."""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from virnet_tpu.data import eval_sets as jsets
from virnet_tpu.eval import metrics as jmetrics
from virnet_tpu.ops import color as jcolor
from virnet_tpu.ops import degrade as jdegrade
from virnet_tpu.ops import pad as jpad
from virnet_tpu.ops import sigma_fields as jfields
from virnet_tpu_torch.data import eval_sets
from virnet_tpu_torch.eval import metrics
from virnet_tpu_torch.ops import color, degrade, pad, sigma_fields
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape)


def _pngs(folder, seed, sizes):
    """Seeded uint8 images written as PNGs; returns their paths."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        paths.append(str(folder / f"{i}.png"))
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = 127 + 100 * np.sin(xx / 5.0 + i)[..., None] * np.cos(
            yy / 7.0)[..., None]
        im = smooth + rng.normal(0, 10, (h, w, 3))
        cv2.imwrite(paths[-1], np.clip(im, 0, 255).astype(np.uint8))
    return paths


# ---------------------------------------------------------------------------
# host degradation and colour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,correlate", [("reflect", False),
                                            ("reflect", True),
                                            ("constant", False)])
def test_imconv_np_is_the_jax_packages(mode, correlate):
    im = _rand(0, 19, 23, 3)
    k = _rand(1, 7, 7)
    np.testing.assert_array_equal(
        degrade.imconv_np(im, k, mode, correlate),
        jdegrade.imconv_np(im, k, mode, correlate))
    np.testing.assert_array_equal(degrade.imconv_np(im[..., 0], k, mode),
                                  jdegrade.imconv_np(im[..., 0], k, mode))


@pytest.mark.parametrize("sf,downsampler,qf", [(2, "direct", None),
                                               (3, "bicubic", None),
                                               (4, "bicubic", 40)])
def test_degrade_np_is_the_jax_packages(sf, downsampler, qf):
    from virnet_tpu_torch.ops.kernels import anisotropic_gaussian_np

    im = _rand(2, 36, 44, 3)
    k, _ = anisotropic_gaussian_np(k_size=11, sf=sf, lambda_1=2.0,
                                   lambda_2=1.0, theta=0.3)
    got = degrade.degrade_np(im, k, sf, nlevel=7.65, qf=qf, seed=1234,
                             downsampler=downsampler)
    want = jdegrade.degrade_np(im, k, sf, nlevel=7.65, qf=qf, seed=1234,
                               downsampler=downsampler)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="downsampler"):
        degrade.degrade_np(im, k, sf, downsampler="area")


def test_color_and_modcrop_are_the_jax_packages():
    im_u8 = (_rand(3, 13, 17, 3) * 255).astype(np.uint8)
    im_f = _rand(4, 13, 17, 3).astype(np.float32)
    for im in (im_u8, im_f):
        for only_y in (True, False):
            got = color.rgb2ycbcr_np(im, only_y)
            assert got.dtype == im.dtype
            np.testing.assert_array_equal(got, jcolor.rgb2ycbcr_np(im, only_y))
        for qf in (10, 90):
            np.testing.assert_array_equal(color.jpeg_compress(im, qf),
                                          jcolor.jpeg_compress(im, qf))
        np.testing.assert_array_equal(color.jpeg_compress(im, 40, "bgr"),
                                      jcolor.jpeg_compress(im, 40, "bgr"))
        for sf in (2, 3, 4):
            np.testing.assert_array_equal(pad.modcrop(im, sf),
                                          jpad.modcrop(im, sf))
    assert pad.modcrop(im_f, 4).shape == (12, 16, 3)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("border,ycbcr", [(0, False), (4, False), (0, True),
                                          (4, True)])
def test_psnr_and_ssim_are_the_jax_packages(border, ycbcr):
    a = (_rand(5, 2, 30, 34, 3) * 255).astype(np.uint8)
    b = np.clip(a + np.random.default_rng(6).normal(0, 9, a.shape), 0,
                255).astype(np.uint8)
    # PSNR bit for bit; SSIM within 1e-12: the port filters without cv2
    # (a 'valid' correlation, sums in another order)
    tol = {"calculate_psnr": 0.0, "calculate_ssim": 1e-12}
    for f in ("calculate_psnr", "calculate_ssim"):
        got = getattr(metrics, f)(a[0], b[0], border, ycbcr)
        want = getattr(jmetrics, f)(a[0], b[0], border, ycbcr)
        assert abs(got - want) <= tol[f], f
    fa, fb = a / 255.0, np.clip(b / 255.0 + 0.003, -0.5, 1.5)
    for f in ("batch_psnr", "batch_ssim"):
        got = getattr(metrics, f)(fa, fb, border, ycbcr)
        want = getattr(jmetrics, f)(fa, fb, border, ycbcr)
        assert abs(got - want) <= tol[f.replace("batch", "calculate")], f
    # gray images and the identical pair
    assert abs(metrics.calculate_ssim(a[0, ..., 0], b[0, ..., 0], border)
               - jmetrics.calculate_ssim(a[0, ..., 0], b[0, ..., 0],
                                         border)) <= 1e-12
    assert metrics.calculate_psnr(a[0], a[0]) == float("inf")
    with pytest.raises(ValueError, match="same dimensions"):
        metrics.calculate_psnr(a[0], a[0, :-1])


# ---------------------------------------------------------------------------
# sigma fields and eval sets
# ---------------------------------------------------------------------------

def test_sigma_fields_are_the_jax_packages():
    np.testing.assert_array_equal(sigma_fields.peaks(64), jfields.peaks(64))
    np.testing.assert_array_equal(sigma_fields.sincos_kernel(),
                                  jfields.sincos_kernel())
    np.testing.assert_array_equal(
        sigma_fields.gaussian_bump(20, 30, (4.5, 11.0), 6.0),
        jfields.gaussian_bump(20, 30, (4.5, 11.0), 6.0))
    np.testing.assert_array_equal(
        sigma_fields.gauss_kernel_mix(96, 128, np.random.default_rng(7)),
        jfields.gauss_kernel_mix(96, 128, np.random.default_rng(7)))
    for case in ("peaks", "sincos", "gauss_mix"):
        got = sigma_fields.benchmark_sigma_field(
            case, rng=np.random.default_rng(8))
        want = jfields.benchmark_sigma_field(case,
                                             rng=np.random.default_rng(8))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown"):
        sigma_fields.benchmark_sigma_field("ramp")


def test_denoise_val_set_is_the_jax_packages(tmp_path):
    paths = _pngs(tmp_path / "val", 9, [(30, 41), (37, 26)])
    ours, theirs = eval_sets.DenoiseValSet(paths), jsets.DenoiseValSet(paths)
    assert len(ours) == 2
    np.testing.assert_array_equal(ours.noise, theirs.noise)
    for (n1, g1), (n2, g2) in zip(ours, theirs):
        assert n1.dtype == np.float32
        np.testing.assert_array_equal(n1, n2)
        np.testing.assert_array_equal(g1, g2)


@pytest.mark.parametrize("noise_type", ["niid", "iid"])
def test_denoise_benchmark_is_the_jax_packages(noise_type):
    ours = eval_sets.DenoiseBenchmark(noise_type)
    theirs = jsets.DenoiseBenchmark(noise_type)
    gt = (_rand(10, 21, 27, 3) * 255).astype(np.uint8)
    for (name, base), (name2, base2) in zip(ours.cases(), theirs.cases()):
        assert name == name2
        np.testing.assert_array_equal(ours.sigma_for(base, 21, 27),
                                      theirs.sigma_for(base2, 21, 27))
        np.testing.assert_array_equal(ours.noisy(gt, base),
                                      theirs.noisy(gt, base2))
    with pytest.raises(ValueError):
        eval_sets.DenoiseBenchmark("poisson")


@pytest.mark.parametrize("sf,downsampler,noise_type", [
    (2, "bicubic", "Gaussian"), (3, "direct", "Gaussian"),
    (4, "bicubic", "JPEG")])
def test_sisr_val_set_is_the_jax_packages(tmp_path, sf, downsampler,
                                          noise_type):
    paths = _pngs(tmp_path / "hr", 11, [(50, 61), (47, 38)])
    kw = dict(sf=sf, k_size=11, downsampler=downsampler,
              noise_type=noise_type)
    ours, theirs = eval_sets.SISRValSet(paths, **kw), \
        jsets.SISRValSet(paths, **kw)
    np.testing.assert_array_equal(ours.fixed_noise, theirs.fixed_noise)
    for a, b in zip(ours, theirs):
        assert a[0].shape[0] % sf == 0 and a[1].dtype == np.float32
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("sf", [2, 3, 4])
def test_table5_kernels_are_the_jax_packages(sf):
    ours, theirs = eval_sets.table5_kernels(sf), jsets.table5_kernels(sf)
    assert len(ours) == 7
    for (k1, i1), (k2, i2) in zip(ours, theirs):
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(i1, i2)


# ---------------------------------------------------------------------------
# validation in the trainers
# ---------------------------------------------------------------------------

def test_eval_on_pairs_is_the_jax_packages():
    """The same restore closure and pairs give the same scores (PSNR bit
    for bit, SSIM within 1e-12), with the SISR protocol's border and Y
    channel as well."""
    from virnet_tpu.cli.common import eval_on_pairs as jax_eval_on_pairs
    from virnet_tpu_torch.cli.common import eval_on_pairs

    pairs = [(_rand(12 + i, 24, 28, 3).astype(np.float32),
              _rand(20 + i, 24, 28, 3).astype(np.float32)) for i in range(3)]

    def restore(im):
        return np.clip(im * 0.9 + 0.05, 0, 1)

    for border, ycbcr in ((0, False), (4, True)):
        got = eval_on_pairs(restore, iter(pairs), border, ycbcr)
        want = jax_eval_on_pairs(restore, iter(pairs), border, ycbcr)
        assert got["psnr"] == want["psnr"]
        # the port's SSIM filters without cv2: sums in another order
        assert abs(got["ssim"] - want["ssim"]) <= 1e-12


@pytest.mark.parametrize("task,sf,hw", [("denoising-syn", None, (30, 41)),
                                        ("sisr", 2, (21, 26))])
def test_eval_restore_fn_matches_the_jax_packages(task, sf, hw):
    """The validation forward (pad to a multiple of 64, fp32, crop, clamp)
    on the demo weights, on the trainers' route (conv_impl='torch'):
    atol 1e-5, the fp32 parity bar."""
    from virnet_tpu.cli.common import eval_restore_fn as jax_restore_fn
    from virnet_tpu.eval.engine import Restorer as JaxRestorer
    from virnet_tpu_torch.cli.common import eval_restore_fn
    from virnet_tpu_torch.convert import load_pth
    from virnet_tpu_torch.models import build_model

    name = ("virnet_denoising_syn_demo.pth" if sf is None
            else f"virnet_sisr_x{sf}_demo.pth")
    ckpt = ROOT / "model_zoo" / name
    jr = JaxRestorer(task, ckpt_path=str(ckpt), sf=sf or 2)
    model = build_model(task, conv_impl="torch")
    model.load_state_dict(load_pth(ckpt), strict=True)
    im = _rand(13, *hw, 3).astype(np.float32)
    got = eval_restore_fn(model.train(), "cpu", sf=sf)(im)
    assert model.training                          # put back as it was
    want = jax_restore_fn(jr.model, jr.params, sf=sf)(im)
    assert got.shape == want.shape == (hw[0] * (sf or 1), hw[1] * (sf or 1),
                                       3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _scores(log: str, label: str):
    lines = [x for x in log.splitlines() if f"{label}: PSNR=" in x]
    return [(float(x.split("PSNR=")[1].split(",")[0]),
             float(x.split("SSIM=")[1])) for x in lines]


def test_syn_cli_validates_each_epoch_on_val_data(tmp_path):
    """The synthetic trainer validates on the PNGs under val_data with
    DenoiseValSet's fixed noise, once per epoch, and logs PSNR and SSIM;
    the scores are eval_on_pairs of the trained model on the same set."""
    from virnet_tpu_torch.cli.common import eval_on_pairs, eval_restore_fn
    from virnet_tpu_torch.cli.train_denoising_syn import build_trainer, main
    from virnet_tpu_torch.config import load_config
    from virnet_tpu_torch.train.checkpoint import CheckpointManager

    train = _pngs(tmp_path / "train", 14, [(40, 48)] * 3)
    val = _pngs(tmp_path / "val", 15, [(33, 37), (40, 29)])
    cfg = tmp_path / "cfg.json"
    cfg.write_text("""{
        "im_chn": 3, "sigma_chn": 1, "patch_size": 32, "batch_size": 2,
        "epochs": 2, "steps_per_epoch": 2, "lr": 1e-4, "print_freq": 1,
        "save_dir": "unused", "dep_S": 3, "n_feat": [16, 24, 32],
        "n_resblocks": 1, "extra_mode": "Input", "noise_cond": true,
        "mixed_precision": "False", "var_window": 7,
        "train_data": [["%s", "*.png"]], "val_data": "%s"
    }""" % (Path(train[0]).parent, Path(val[0]).parent))
    save = tmp_path / "run"
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu"])
    scores = _scores((save / "train.log").read_text(), "test")
    assert len(scores) == 2 and all(np.isfinite(scores).all(axis=1))
    c = load_config(str(cfg))
    c["save_dir"] = str(save)
    trainer = build_trainer(c, device="cpu")
    trainer.restore(2)
    want = eval_on_pairs(eval_restore_fn(trainer.model, "cpu"),
                         iter(eval_sets.DenoiseValSet(val)))
    assert scores[-1] == (round(want["psnr"], 2), round(want["ssim"], 4))
    assert CheckpointManager(save).steps() == [1, 2]


def test_sisr_cli_validates_each_epoch_on_val_hr_path(tmp_path):
    """The SISR trainer validates on SISRValSet(Gaussian) over the PNGs
    under val_hr_path, Y channel with a border of sf^2, and logs PSNR and
    SSIM per set; without val_hr_path it skips validation."""
    from virnet_tpu_torch.cli.train_sisr import main

    hr = _pngs(tmp_path / "hr", 16, [(40, 48)] * 3)
    val = _pngs(tmp_path / "set14", 17, [(42, 46), (36, 50)])
    body = """
        "im_chn": 3, "sigma_chn": 1, "hr_size": 32, "batch_size": 2,
        "epochs": 1, "steps_per_epoch": 1, "lr": 2e-4, "print_freq": 1,
        "save_dir": "unused", "dep_S": 3, "dep_K": 2,
        "n_feat": [16, 24, 32], "n_resblocks": 1, "extra_mode": "Both",
        "train_hr_patchs": "%s", "sf": 2, "k_size": 5,
        "mixed_precision": "False", "downsampler": "Bicubic"
    """ % Path(hr[0]).parent
    cfg = tmp_path / "cfg.json"
    cfg.write_text("{%s, \"val_hr_path\": \"%s\"}"
                   % (body, Path(val[0]).parent))
    main(["--config", str(cfg), "--save_dir", str(tmp_path / "run"),
          "--device", "cpu"])
    scores = _scores((tmp_path / "run" / "train.log").read_text(),
                     "test[Gaussian]")
    assert len(scores) == 1 and np.isfinite(scores).all()
    assert 0 < scores[0][1] <= 1
    cfg.write_text("{%s}" % body)
    main(["--config", str(cfg), "--save_dir", str(tmp_path / "run2"),
          "--device", "cpu"])
    assert "PSNR=" not in (tmp_path / "run2" / "train.log").read_text()


def test_validation_forward_leaves_cudnn_as_it_was():
    """The im2col route of the fp32 forward on the card is a context
    variable, never cuDNN's process-wide flag: a block (the validation
    forward's, a Restorer's) leaves ``cudnn.enabled`` as it was, nests,
    ends with its block, and another thread does not see it while it
    lasts."""
    import threading

    from virnet_tpu_torch.cli.common import eval_restore_fn
    from virnet_tpu_torch.models import build_model
    from virnet_tpu_torch.precision import im2col_convs, im2col_on

    saved = torch.backends.cudnn.enabled
    seen = {}
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(5)
        seen["other"] = im2col_on()
        done.set()

    t = threading.Thread(target=other)
    t.start()
    assert not im2col_on()
    with im2col_convs():
        assert im2col_on() and torch.backends.cudnn.enabled == saved
        with im2col_convs(False):
            assert not im2col_on()
        assert im2col_on()
        inside.set()
        done.wait(5)
    t.join()
    assert seen == {"other": False} and not im2col_on()
    assert torch.backends.cudnn.enabled == saved
    restore = eval_restore_fn(build_model("denoising-syn").eval(), "cpu")
    out = restore(_rand(3, 12, 14, 3).astype(np.float32))
    assert out.shape == (12, 14, 3) and not im2col_on()
    assert torch.backends.cudnn.enabled == saved


# ---------------------------------------------------------------------------
# the trainers' TensorBoard image and kernel grids
# ---------------------------------------------------------------------------

class _Recorder:
    """A writer with TrainWriter's methods and a backend, keeping every
    scalar and image batch it is given."""

    enabled = True

    def __init__(self, *args):
        self.scalars, self.images = [], []

    def scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def image_grid(self, tag, batch, step, normalize=True):
        self.images.append((tag, np.array(batch), step))

    def close(self):
        pass


def _recording(monkeypatch, module):
    """Make ``module``'s TrainWriter a _Recorder; returns the list that
    receives each one built."""
    made = []

    def make(*args):
        made.append(_Recorder(*args))
        return made[-1]

    monkeypatch.setattr(module, "TrainWriter", make)
    return made


@pytest.mark.parametrize("sf,max_images,crop", [(None, 4, 256),
                                                (None, 2, 20), (2, 4, 30)])
def test_log_val_image_grids_is_the_jax_packages(sf, max_images, crop):
    """One numpy restore and the same pairs (of three sizes, one over the
    crop): the same tags, steps and arrays, bit for bit, with the common
    h x w cut of the three lists."""
    from virnet_tpu.cli.common import log_val_image_grids as jax_grids
    from virnet_tpu_torch.cli.common import log_val_image_grids

    pairs = [(_rand(30 + i, h, w, 3).astype(np.float32) * 1.2 - 0.1,
              _rand(40 + i, h * (sf or 1), w * (sf or 1), 3).astype(
                  np.float32))
             for i, (h, w) in enumerate([(26, 31), (300, 270), (22, 40),
                                         (33, 33), (40, 28)])]

    def restore(im):
        out = im * 0.9 + 0.05
        return out if sf is None else out.repeat(sf, 0).repeat(sf, 1)

    got, want = _Recorder(), _Recorder()
    log_val_image_grids(got, restore, iter(pairs), 3, tag="test_x",
                        max_images=max_images, crop=crop)
    jax_grids(want, restore, iter(pairs), 3, tag="test_x",
              max_images=max_images, crop=crop)
    assert [(t, s) for t, _, s in got.images] == [
        (t, s) for t, _, s in want.images] == [
        ("test_x Restored images", 3), ("test_x GroundTruth", 3),
        ("test_x Input", 3)]
    for (_, a, _), (_, b, _) in zip(got.images, want.images):
        assert a.dtype == b.dtype and a.shape[0] == max_images
        np.testing.assert_array_equal(a, b)
    h = min(22, crop)
    assert got.images[0][1].shape[1] == h
    assert got.images[2][1].min() >= 0 and got.images[2][1].max() <= 1


def test_grids_without_a_writer_backend_do_no_work(monkeypatch, tmp_path):
    """Without tensorboardX the writer has no backend: neither the grids
    nor the kernel image restores, reads a pair or runs the model."""
    import sys

    from virnet_tpu_torch.cli.common import log_val_image_grids
    from virnet_tpu_torch.cli.train_sisr import log_kernel_image
    from virnet_tpu_torch.train.logging import TrainWriter

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    writer = TrainWriter(tmp_path / "logs")
    assert writer.writer is None and not writer.enabled
    calls = []

    def pairs():
        calls.append("pairs")
        yield _rand(0, 8, 8, 3), _rand(1, 8, 8, 3)

    log_val_image_grids(writer, lambda im: calls.append("restore"), pairs(),
                        0)

    class _Model(torch.nn.Module):
        def forward(self, *args):
            calls.append("model")

    log_kernel_image(writer, _Model(), "cpu", pairs(), 0, "test_Gaussian",
                     k_size=5, sf=2)
    writer.image_grid("t", np.zeros((1, 4, 4, 3)), 0)
    assert calls == []


def test_sisr_cli_writes_image_and_kernel_grids(monkeypatch, tmp_path):
    """One tiny SISR epoch on the CPU: the JAX trainer's four image tags
    for the val set; the kernel image (2, k, k, 1) sums to 1 per kernel
    and is the JAX kinfo2kernel of the trained model's kinfo and of the
    GT kinfo (atol 1e-7, as tests/test_torch_port_blur.py holds the two
    functions); the LR grid is the val set's LR images cut to the common
    h x w."""
    import virnet_tpu.ops.kernels as jker
    import jax.numpy as jnp
    from virnet_tpu_torch.cli import train_sisr
    from virnet_tpu_torch.cli.common import eval_forward
    from virnet_tpu_torch.config import load_config

    made = _recording(monkeypatch, train_sisr)
    hr = _pngs(tmp_path / "hr", 18, [(40, 48)] * 2)
    val = _pngs(tmp_path / "set14", 19, [(42, 46), (36, 50)])
    cfg = tmp_path / "cfg.json"
    cfg.write_text("""{
        "im_chn": 3, "sigma_chn": 1, "hr_size": 32, "batch_size": 2,
        "epochs": 1, "steps_per_epoch": 1, "lr": 2e-4, "print_freq": 1,
        "save_dir": "unused", "dep_S": 3, "dep_K": 2,
        "n_feat": [16, 24, 32], "n_resblocks": 1, "extra_mode": "Both",
        "train_hr_patchs": "%s", "sf": 2, "k_size": 5,
        "mixed_precision": "False", "downsampler": "Bicubic",
        "val_hr_path": "%s"
    }""" % (Path(hr[0]).parent, Path(val[0]).parent))
    save = tmp_path / "run"
    train_sisr.main(["--config", str(cfg), "--save_dir", str(save),
                     "--device", "cpu"])
    images = {tag: (arr, step) for tag, arr, step in made[0].images}
    assert sorted(images) == sorted(
        f"test_Gaussian {t}" for t in ("Restored images", "GroundTruth",
                                       "Input", "Kernel est|gt"))
    assert {step for _, step in images.values()} == {0}
    kers = images["test_Gaussian Kernel est|gt"][0]
    assert kers.shape == (2, 5, 5, 1) and kers.dtype == np.float32
    np.testing.assert_allclose(kers.sum(axis=(1, 2, 3)), 1.0, atol=1e-6)

    c = load_config(str(cfg))
    c["save_dir"] = str(save)
    trainer = train_sisr.build_trainer(c, device="cpu")
    trainer.restore(1)
    val_set = train_sisr.sisr_val_sets(c)["Gaussian"]
    _, lr0, kinfo_gt = next(iter(val_set))
    with eval_forward(trainer.model, "cpu"):
        kinfo_est = trainer.model(torch.from_numpy(lr0[None]), 2)[1].numpy()
    want = np.asarray(jker.kinfo2kernel(
        jnp.asarray(np.concatenate([kinfo_est, kinfo_gt[None]])), 5, 2))
    np.testing.assert_allclose(kers[..., 0], want, atol=1e-7)
    lrs = [np.clip(lr, 0, 1) for _, lr, _ in val_set]
    h, w = min(x.shape[0] for x in lrs), min(x.shape[1] for x in lrs)
    np.testing.assert_array_equal(images["test_Gaussian Input"][0],
                                  np.stack([x[:h, :w] for x in lrs]))
    for tag in ("Restored images", "GroundTruth"):
        grid = images[f"test_Gaussian {tag}"][0]
        assert grid.shape == (2, h, w, 3) and np.isfinite(grid).all()
        assert grid.min() >= 0 and grid.max() <= 1


@pytest.mark.parametrize("kind", ["syn", "real"])
def test_denoising_clis_write_image_grids(monkeypatch, tmp_path, kind):
    """One tiny epoch of each denoising trainer on the CPU: the JAX
    trainer's three image tags under ``test``, the GT and input grids the
    val pairs cut to their common h x w, the restored grid in [0, 1]."""
    from scipy.io import savemat

    from virnet_tpu_torch.cli import train_denoising_real, train_denoising_syn

    train = _pngs(tmp_path / "train", 20, [(40, 48)] * 2)
    common = """
        "im_chn": 3, "patch_size": 32, "batch_size": 2, "epochs": 1,
        "steps_per_epoch": 1, "lr": 1e-4, "print_freq": 1,
        "save_dir": "unused", "dep_S": 3, "n_feat": [16, 24, 32],
        "n_resblocks": 1, "extra_mode": "Input", "noise_cond": true,
        "mixed_precision": "False", "var_window": 7"""
    if kind == "syn":
        cli = train_denoising_syn
        val = _pngs(tmp_path / "val", 21, [(33, 37), (40, 29)])
        body = ('"sigma_chn": 1, "train_data": [["%s", "*.png"]], '
                '"val_data": "%s"' % (Path(train[0]).parent,
                                      Path(val[0]).parent))
        pairs = list(eval_sets.DenoiseValSet(val))
    else:
        cli = train_denoising_real
        for sub in ("noisy", "gt"):
            _pngs(tmp_path / "pairs" / sub, 22, [(40, 48)] * 2)
        rng = np.random.default_rng(23)
        gt = (rng.random((1, 2, 24, 20, 3)) * 255).astype(np.uint8)
        noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0,
                        255).astype(np.uint8)
        savemat(str(tmp_path / "n.mat"), {"ValidationNoisyBlocksSrgb": noisy})
        savemat(str(tmp_path / "g.mat"), {"ValidationGtBlocksSrgb": gt})
        body = ('"sigma_chn": 3, "train_pch_dir": "%s", '
                '"test_noisy_path": "%s", "test_gt_path": "%s"'
                % (tmp_path / "pairs" / "noisy", tmp_path / "n.mat",
                   tmp_path / "g.mat"))
        pairs = list(cli.sidd_val_pairs(str(tmp_path / "n.mat"),
                                        str(tmp_path / "g.mat")))
    cfg = tmp_path / "cfg.json"
    cfg.write_text("{%s, %s}" % (common, body))
    made = _recording(monkeypatch, cli)
    cli.main(["--config", str(cfg), "--save_dir", str(tmp_path / "run"),
              "--device", "cpu"])
    images = {tag: arr for tag, arr, _ in made[0].images}
    assert sorted(images) == ["test GroundTruth", "test Input",
                              "test Restored images"]
    h = min(x.shape[0] for p in pairs for x in p)
    w = min(x.shape[1] for p in pairs for x in p)
    for tag, j in (("test Input", 0), ("test GroundTruth", 1)):
        np.testing.assert_array_equal(
            images[tag], np.stack([np.clip(p[j], 0, 1)[:h, :w]
                                   for p in pairs]))
    out = images["test Restored images"]
    assert out.shape == (len(pairs), h, w, 3)
    assert np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
