"""The port's benchmark harnesses (virnet_tpu_torch/eval/{tta,
metrics_device,analysis,profiling,tables,lpips,dnd}.py, ops/augment.py's
tensor forms, ops/color.py:rgb2ycbcr and the four eval command lines)
against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs and the same weights (a JAX
parameter tree carried across by convert.from_jax_params, or a demo
checkpoint of model_zoo/).  Each tolerance is stated where it is used."""

import pickle
import sys
from pathlib import Path

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from virnet_tpu.eval import dnd as jdnd
from virnet_tpu.eval import lpips as jlpips
from virnet_tpu.eval import metrics as jmetrics
from virnet_tpu.eval import tables as jtables
from virnet_tpu.eval.engine import Restorer as JaxRestorer
from virnet_tpu.eval.metrics_device import batch_psnr_device as jpsnr_dev
from virnet_tpu.eval.metrics_device import batch_ssim_device as jssim_dev
from virnet_tpu.eval.tta import tta_x8 as jtta_x8
from virnet_tpu.models import build_model as jbuild_model
from virnet_tpu.ops import augment as jaugment
from virnet_tpu.ops import color as jcolor
from virnet_tpu_torch.convert import from_jax_params
from virnet_tpu_torch.eval import analysis, dnd, lpips, metrics, tables
from virnet_tpu_torch.eval.engine import Restorer
from virnet_tpu_torch.eval.metrics_device import (batch_psnr_device,
                                                  batch_ssim_device)
from virnet_tpu_torch.eval.tta import tta_x8
from virnet_tpu_torch.ops import augment, color
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
ZOO = ROOT / "model_zoo"
REAL = str(ZOO / "virnet_denoising_real_demo.pth")
SYN = str(ZOO / "virnet_denoising_syn_demo.pth")
TINY = {"denoising-syn": dict(n_feat=(8, 16), dep_S=3, n_resblocks=1),
        "sisr": dict(n_feat=(8, 16), dep_S=3, dep_K=2, n_resblocks=1)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tiny_pair(task, sf=2):
    """The JAX and port Restorers of a tiny ``task`` model with the same
    seeded weights (tests/test_tables_batched.py's sizes)."""
    over = TINY[task]
    model = jbuild_model(task, **over)
    x = jnp.zeros((1, 16, 16, 3))
    params = (model.init(jax.random.PRNGKey(0), x, sf) if task == "sisr"
              else model.init(jax.random.PRNGKey(0), x))["params"]
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return (JaxRestorer(task, params=params, sf=sf, **over),
            Restorer(task, state_dict=sd, sf=sf, device="cpu", **over))


def _per_image_convs():
    """PyTorch's CPU convolutions without oneDNN, which convolve image by
    image: a batch's make-up then cannot move a score (oneDNN's choices do,
    by ~1e-7 before the uint8 rounding)."""
    return torch.backends.mkldnn.flags(enabled=False)


def _record_inputs(restorer):
    """Record the numpy batches handed to ``restorer.restore_batch``."""
    calls = []
    fn = restorer.restore_batch

    def rec(x):
        calls.append(np.array(x))
        return fn(x)

    restorer.restore_batch = rec
    return calls


def _pngs(folder, seed, shapes, ext=".png"):
    """Seeded smooth uint8 images with noise, written with cv2."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[0:h, 0:w]
        im = 127 + 90 * (np.sin(xx / 5.0 + i)[..., None]
                         * np.cos(yy / 7.0)[..., None])
        im = im + rng.normal(0, 12, (h, w, 3))
        cv2.imwrite(str(folder / f"im{i}{ext}"),
                    np.clip(im, 0, 255).astype(np.uint8))
    return folder


# ---------------------------------------------------------------------------
# the dihedral family and the device ensemble
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", range(8))
def test_dihedral_family_is_the_jax_packages(mode):
    """Bit for bit: each is a permutation of the values."""
    x = _rand(mode, 2, 6, 6, 3)
    got = augment.dihedral(_t(x), mode)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jaugment.dihedral(x, mode)))
    np.testing.assert_array_equal(
        augment.dihedral_inverse(_t(x), mode).numpy(),
        np.asarray(jaugment.dihedral_inverse(x, mode)))
    np.testing.assert_array_equal(augment.dihedral_inverse(got, mode).numpy(),
                                  x)
    # rectangular HWC images too
    r = _rand(10 + mode, 5, 7, 2)
    np.testing.assert_array_equal(augment.dihedral(_t(r), mode).numpy(),
                                  np.asarray(jaugment.dihedral(r, mode)))


def test_dihedral_stack_and_mean_are_the_jax_packages():
    """The stack bit for bit; the mean of the 8 inverse-mapped orientations
    within 1e-7 (8 float32 terms, sums in another order)."""
    x = _rand(20, 2, 5, 5, 3)
    stack = augment.dihedral_stack(_t(x))
    np.testing.assert_array_equal(stack.numpy(),
                                  np.asarray(jaugment.dihedral_stack(x)))
    y8 = _rand(21, 8, 2, 5, 5, 3)
    np.testing.assert_allclose(
        augment.dihedral_unstack_mean(_t(y8)).numpy(),
        np.asarray(jaugment.dihedral_unstack_mean(y8)), atol=1e-7)
    np.testing.assert_allclose(augment.dihedral_unstack_mean(stack).numpy(),
                               x, atol=1e-7)
    with pytest.raises(ValueError, match="mode"):
        augment.dihedral(_t(x), 8)


def test_tta_x8_matches_jax_on_a_shift_variant_forward():
    """A linear forward that depends on position (a weight map and a
    channel mix), so a wrong inverse shows: atol 1e-6."""
    x = _rand(22, 3, 9, 9, 3)
    wmap = _rand(23, 9, 9, 1)
    mix = _rand(24, 3, 3)

    got = tta_x8(lambda b: (b * _t(wmap)) @ _t(mix), _t(x))
    want = jtta_x8(lambda b: (b * wmap) @ mix, jnp.asarray(x))
    assert got.shape == (3, 9, 9, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match="square"):
        tta_x8(lambda b: b, _t(_rand(25, 1, 4, 6, 3)))


# ---------------------------------------------------------------------------
# metrics: the host SSIM without cv2, the device metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("border,ycbcr", [(0, False), (4, False), (0, True),
                                          (4, True)])
def test_host_ssim_runs_without_cv2(monkeypatch, border, ycbcr):
    """The port's host SSIM with cv2 blocked equals the JAX package's
    cv2-based one to 1e-12 (float64 maps; sums in another order)."""
    a = (_rand(30, 2, 33, 41, 3) * 255).astype(np.uint8)
    b = np.clip(a + np.random.default_rng(31).normal(0, 9, a.shape), 0,
                255).astype(np.uint8)
    want = [jmetrics.calculate_ssim(a[i], b[i], border, ycbcr)
            for i in range(2)]
    want_gray = jmetrics.calculate_ssim(a[0, ..., 1], b[0, ..., 1], border)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    for i in range(2):
        assert abs(metrics.calculate_ssim(a[i], b[i], border, ycbcr)
                   - want[i]) <= 1e-12
    assert abs(metrics.calculate_ssim(a[0, ..., 1], b[0, ..., 1], border)
               - want_gray) <= 1e-12
    assert metrics.calculate_ssim(a[0], a[0]) == 1.0


def test_metrics_module_imports_no_cv2():
    import ast

    tree = ast.parse((ROOT / "virnet_tpu_torch" / "eval" /
                      "metrics.py").read_text())
    names = {a.name for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in n.names} | {n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)}
    assert "cv2" not in names


def test_rgb2ycbcr_is_the_jax_packages():
    x = _rand(32, 2, 7, 9, 3)
    for only_y in (True, False):
        np.testing.assert_allclose(
            color.rgb2ycbcr(_t(x), only_y).numpy(),
            np.asarray(jcolor.rgb2ycbcr(jnp.asarray(x), only_y)), atol=1e-6)


def _noisy_pair(seed, n=3, h=48, w=56):
    rng = np.random.default_rng(seed)
    clean = rng.random((n, h, w, 3)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.05, clean.shape), 0,
                    1).astype(np.float32)
    return noisy, clean


@pytest.mark.parametrize("border,ycbcr", [(0, False), (4, True)])
def test_device_metrics_match_jax_and_the_host_scorers(border, ycbcr):
    """The bars of tests/test_metrics_device.py: PSNR 1e-3 dB against the
    host scorer (2e-3 with the Y channel), SSIM 1e-4; and the same bars
    against the JAX package's device metrics."""
    noisy, clean = _noisy_pair(33 + border)
    p = batch_psnr_device(_t(noisy), _t(clean), border, ycbcr).numpy()
    s = batch_ssim_device(_t(noisy), _t(clean), border, ycbcr).numpy()
    assert p.shape == s.shape == (3,)
    jp = np.asarray(jpsnr_dev(jnp.asarray(noisy), jnp.asarray(clean),
                              border=border, ycbcr=ycbcr))
    js = np.asarray(jssim_dev(jnp.asarray(noisy), jnp.asarray(clean),
                              border=border, ycbcr=ycbcr))
    bar = 2e-3 if ycbcr else 1e-3
    np.testing.assert_allclose(p, jp, atol=bar)
    np.testing.assert_allclose(s, js, atol=1e-4)
    for i in range(3):
        host_p = metrics.batch_psnr(noisy[i:i + 1], clean[i:i + 1], border,
                                    ycbcr)
        host_s = metrics.batch_ssim(noisy[i:i + 1], clean[i:i + 1], border,
                                    ycbcr)
        assert abs(p[i] - host_p) < bar, (p[i], host_p)
        assert abs(s[i] - host_s) < 1e-4, (s[i], host_s)


# ---------------------------------------------------------------------------
# the table harnesses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def denoise_pair():
    return _tiny_pair("denoising-syn")


@pytest.fixture(scope="module")
def sisr_pair():
    return _tiny_pair("sisr", sf=2)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Four seeded PNGs: three of one shape, one of its transpose."""
    return _pngs(tmp_path_factory.mktemp("tables"), 40,
                 [(40, 48)] * 3 + [(48, 40)])


@pytest.mark.parametrize("noise_type", ["niid", "iid"])
def test_eval_denoise_synthetic_matches_jax(denoise_pair, images,
                                            noise_type):
    """Table 1/2: the noisy inputs bit for bit, per-image PSNR within 0.01
    dB and SSIM within 1e-4 of the JAX harness; the port's batch 1 and
    batch 4 give equal scores."""
    jr, tr = denoise_pair
    jin, tin = _record_inputs(jr), _record_inputs(tr)
    quiet = dict(log_fn=lambda *a: None)
    want = jtables.eval_denoise_synthetic(jr, {"tiny": str(images)},
                                          noise_type, batch_size=4, **quiet)
    with _per_image_convs():
        got = tables.eval_denoise_synthetic(tr, {"tiny": str(images)},
                                            noise_type, batch_size=4, **quiet)
        one = tables.eval_denoise_synthetic(tr, {"tiny": str(images)},
                                            noise_type, batch_size=1, **quiet)
    del jr.restore_batch, tr.restore_batch
    assert len(jin) == 6 and len(tin) == 6 + 12   # 3 cases x 2 shapes
    for a, b in zip(tin, jin):
        np.testing.assert_array_equal(a, b)
    assert list(got["tiny"]) == list(want["tiny"])
    for case, rec in got["tiny"].items():
        ref = want["tiny"][case]
        assert rec["psnr_per_image"].keys() == ref["psnr_per_image"].keys()
        for name, v in rec["psnr_per_image"].items():
            assert abs(v - ref["psnr_per_image"][name]) < 0.01
            assert abs(rec["ssim_per_image"][name]
                       - ref["ssim_per_image"][name]) < 1e-4
            assert one["tiny"][case]["psnr_per_image"][name] == v
            assert one["tiny"][case]["ssim_per_image"][name] == \
                rec["ssim_per_image"][name]
        assert rec["seconds"] > 0


def test_eval_sisr_synthetic_matches_jax(sisr_pair, tmp_path):
    """Table 5 at x2: the LR inputs bit for bit, each kernel's mean PSNR-Y
    within 0.01 dB and SSIM-Y within 1e-4 of the JAX harness; batch 1 and
    batch 4 give equal per-image scores; LPIPS off records its reason."""
    jr, tr = sisr_pair
    d = _pngs(tmp_path / "hr", 41, [(41, 48)] * 3 + [(48, 41)])
    jin, tin = _record_inputs(jr), _record_inputs(tr)
    quiet = dict(log_fn=lambda *a: None, use_lpips=False)
    want = jtables.eval_sisr_synthetic(jr, {"tiny": str(d)}, sf=2,
                                       batch_size=4, **quiet)
    with _per_image_convs():
        got = tables.eval_sisr_synthetic(tr, {"tiny": str(d)}, sf=2,
                                         batch_size=4, **quiet)
        one = tables.eval_sisr_synthetic(tr, {"tiny": str(d)}, sf=2,
                                         batch_size=1, **quiet)
    del jr.restore_batch, tr.restore_batch
    assert len(jin) == 14 and len(tin) == 14 + 28  # 7 kernels x 2 LR shapes
    for a, b in zip(tin, jin):
        assert a.shape[1:3] in ((20, 24), (24, 20))     # modcropped by 2
        np.testing.assert_array_equal(a, b)
    assert len(got["tiny"]["per_kernel"]) == 7
    for k, (rec, ref) in enumerate(zip(got["tiny"]["per_kernel"],
                                       want["tiny"]["per_kernel"])):
        assert abs(rec["psnr"] - ref["psnr"]) < 0.01
        assert abs(rec["ssim"] - ref["ssim"]) < 1e-4
        assert rec["lpips"] == ref["lpips"] == lpips.skip_reason()
        assert rec["psnr_per_image"] == \
            one["tiny"]["per_kernel"][k]["psnr_per_image"]
    assert abs(got["tiny"]["psnr"] - want["tiny"]["psnr"]) < 0.01


def _sidd_mats(folder, seed, n_img=2, n_blk=2, size=32):
    """A seeded SIDD validation pair in the real layout: uint8 (images,
    blocks, h, w, 3) arrays under the real keys, smooth images plus
    noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    gt = np.empty((n_img, n_blk, size, size, 3), np.uint8)
    for i in range(n_img):
        for j in range(n_blk):
            f = rng.uniform(0.5, 3, (3, 2))
            im = 0.5 + 0.35 * np.cos(2 * np.pi * (f[:, 0] * yy[..., None]
                                                  + f[:, 1] * xx[..., None]))
            gt[i, j] = np.round(im * 255)
    noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(np.uint8)
    folder.mkdir(parents=True, exist_ok=True)
    sio.savemat(str(folder / "ValidationNoisyBlocksSrgb.mat"),
                {"ValidationNoisyBlocksSrgb": noisy})
    sio.savemat(str(folder / "ValidationGtBlocksSrgb.mat"),
                {"ValidationGtBlocksSrgb": gt})
    return folder


@pytest.fixture(scope="module")
def real_pair():
    return (JaxRestorer("denoising-real", ckpt_path=REAL),
            Restorer("denoising-real", ckpt_path=REAL, device="cpu"))


@pytest.mark.parametrize("flip", [True, False])
def test_eval_sidd_matches_jax(real_pair, tmp_path, flip):
    """Table 4 on 2x2 blocks of 32^2 with the denoising-real demo weights:
    PSNR within 0.01 dB and SSIM within 1e-4 of the JAX harness; the
    denoised uint8 blocks differ in at most 0.1% of values, by at most 1."""
    jr, tr = real_pair
    d = _sidd_mats(tmp_path, 50)
    args = (str(d / "ValidationNoisyBlocksSrgb.mat"),
            str(d / "ValidationGtBlocksSrgb.mat"), flip)
    lines = []
    got = tables.eval_sidd(tr, *args, log_fn=lines.append)
    want = jtables.eval_sidd(jr, *args, log_fn=lambda *a: None)
    assert abs(got["psnr"] - want["psnr"]) < 0.01
    assert abs(got["ssim"] - want["ssim"]) < 1e-4
    assert got["blocks"].shape == want["blocks"].shape == (4, 32, 32, 3)
    diff = np.abs(got["blocks"].astype(int) - want["blocks"].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert got["megatime"] > 0
    assert lines[-1].startswith("SIDD: PSNR=") and \
        f"tta={'x8' if flip else 'off'}" in lines[-1]


def test_sidd_table_device_metrics_and_test_mode(real_pair):
    """The core on block arrays: the device metrics score what the host
    scorers do (PSNR 1e-3 dB, SSIM 1e-4 per block), the blocks are the
    same, batches of 3 take ceil(n / 3) forwards, and without GT (--test)
    nothing is scored."""
    _, tr = real_pair
    gt = (_rand(51, 5, 16, 16, 3) * 255).astype(np.uint8)
    noisy = np.clip(gt + np.random.default_rng(52).normal(0, 10, gt.shape),
                    0, 255).astype(np.uint8)
    quiet = dict(log_fn=lambda *a: None, batch=3)
    host = tables.sidd_table(tr, noisy, gt, **quiet)
    dev = tables.sidd_table(tr, noisy, gt, device_metrics=True, **quiet)
    np.testing.assert_array_equal(host["blocks"], dev["blocks"])
    assert len(host["forward_seconds"]) == len(dev["forward_seconds"]) == 2
    np.testing.assert_allclose(dev["psnr_per_block"], host["psnr_per_block"],
                               atol=1e-3)
    np.testing.assert_allclose(dev["ssim_per_block"], host["ssim_per_block"],
                               atol=1e-4)
    test = tables.sidd_table(tr, noisy, None, flip_tta=False, **quiet)
    assert test["psnr"] is None and test["blocks"].shape == noisy.shape


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def _lpips_weights(seed=0):
    """Seeded random LPIPS-alex weights in both on-disk layouts, as
    tests/test_lpips.py builds them."""
    g = torch.Generator().manual_seed(seed)
    specs = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
             (256, 256, 3)]
    tv_idx = [0, 3, 6, 8, 10]
    lpips_sd = {"scaling_layer.shift": torch.tensor(
        [-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
        "scaling_layer.scale": torch.tensor(
            [0.458, 0.448, 0.450]).view(1, 3, 1, 1)}
    alex, lin = {}, {}
    for k, (ci, co, ks) in enumerate(specs):
        w = torch.randn(co, ci, ks, ks, generator=g) * 0.05
        b = torch.randn(co, generator=g) * 0.05
        lw = (torch.rand(co, generator=g) * 0.1).reshape(1, co, 1, 1)
        lpips_sd[f"net.slice{k + 1}.{tv_idx[k]}.weight"] = w
        lpips_sd[f"net.slice{k + 1}.{tv_idx[k]}.bias"] = b
        lpips_sd[f"lin{k}.model.1.weight"] = lw
        alex[f"features.{tv_idx[k]}.weight"] = w
        alex[f"features.{tv_idx[k]}.bias"] = b
        lin[f"lin{k}.model.1.weight"] = lw
    return {"lpips": lpips_sd, "split": {"alex": alex, "lin": lin}}


@pytest.mark.parametrize("layout", ["lpips", "split"])
def test_lpips_matches_jax(layout, tmp_path, monkeypatch):
    """LPIPSAlex against the JAX package's lpips_pair on seeded random
    weights, loaded from a torch file in each layout: rtol 1e-5; identical
    images give 0; lpips_rgb finds the file through VIRNET_LPIPS_WEIGHTS."""
    sd = _lpips_weights()[layout]
    path = tmp_path / "lpips_alex.pth"
    torch.save(sd, path)
    rng = np.random.default_rng(60)
    x0 = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    x1 = np.clip(x0 + rng.normal(0, 0.2, x0.shape), -1, 1).astype(np.float32)
    net = lpips.LPIPSAlex(lpips.load_lpips_params(str(path)))
    with torch.inference_mode():
        got = net(_t(x0), _t(x1)).numpy()
        same = net(_t(x0), _t(x0)).numpy()
    want = np.asarray(jlpips.lpips_pair(jlpips.load_lpips_params(sd), x0, x1))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(same, 0.0)

    monkeypatch.setenv("VIRNET_LPIPS_WEIGHTS", str(path))
    monkeypatch.setattr(lpips, "_PARAMS", None)
    monkeypatch.setattr(lpips, "_NETS", {})
    assert lpips.available()
    a = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-30, 30, a.shape), 0,
                255).astype(np.uint8)
    d = lpips.lpips_rgb(a, b, "cpu")
    with torch.inference_mode():
        want_ab = float(net(_t(lpips.normalize_lpips(a)),
                            _t(lpips.normalize_lpips(b)))[0])
    assert d == want_ab and d > 0
    assert lpips.lpips_rgb(a, a, "cpu") == 0.0


def test_lpips_absent_weights_are_loud(tmp_path, monkeypatch):
    monkeypatch.setenv("VIRNET_LPIPS_WEIGHTS", str(tmp_path / "none.pth"))
    monkeypatch.setattr(lpips, "_PARAMS", None)
    assert not lpips.available()
    assert "none.pth" in lpips.skip_reason()
    with pytest.raises(RuntimeError, match="VIRNET_LPIPS_WEIGHTS"):
        lpips.lpips_rgb(np.zeros((8, 8, 3), np.uint8),
                        np.zeros((8, 8, 3), np.uint8), "cpu")
    with pytest.raises(ValueError, match="conv1"):
        lpips.load_lpips_params({"lin0.weight": torch.zeros(64)})


# ---------------------------------------------------------------------------
# DND
# ---------------------------------------------------------------------------

N_IMG, N_BOX, IMG, CROP = 50, 20, 16, 8    # the official loop's 50 x 20


@pytest.fixture(scope="module")
def dnd_folder(tmp_path_factory):
    """A synthetic DND folder in the official kit's layout (info.mat and
    images_srgb/ as MATLAB v7.3 HDF5), as tests/test_dnd_raw.py builds it."""
    root = tmp_path_factory.mktemp("dnd")
    (root / "images_srgb").mkdir()
    rng = np.random.default_rng(0)
    with h5py.File(root / "info.mat", "w") as f:
        info = f.create_group("info")
        ref_dtype = h5py.special_dtype(ref=h5py.Reference)
        bb_refs = np.empty((1, N_IMG), dtype=object)
        nlf_refs = np.empty((1, N_IMG), dtype=object)
        for i in range(N_IMG):
            boxes = np.zeros((N_BOX, 4))
            for k in range(N_BOX):
                y0 = 2 * int(rng.integers(0, (IMG - CROP) // 2 + 1))
                x0 = 2 * int(rng.integers(0, (IMG - CROP) // 2 + 1))
                boxes[k] = [y0 + 1, x0 + 1, y0 + CROP, x0 + CROP]
            bb_refs[0, i] = info.create_dataset(f"bb{i}", data=boxes.T).ref
            g = info.create_group(f"nlf{i}")
            g.create_dataset("a", data=np.full((1, 1), 0.01 * (i + 1)))
            g.create_dataset("b", data=np.full((1, 1), 1e-4))
            nlf_refs[0, i] = g.ref
        info.create_dataset("boundingboxes", data=bb_refs, dtype=ref_dtype)
        info.create_dataset("nlf", data=nlf_refs, dtype=ref_dtype)
    for i in range(N_IMG):
        srgb = rng.random((IMG, IMG, 3)).astype(np.float32)
        with h5py.File(root / "images_srgb" / f"{i + 1:04d}.mat", "w") as f:
            f.create_dataset("InoisySRGB", data=srgb.T)
    return root


def test_denoise_srgb_and_bundle_match_jax(dnd_folder, tmp_path):
    """The official loop and the bundler, with a numpy denoiser that reads
    the per-image NLF: every crop .mat and every bundle equal to the JAX
    package's bit for bit."""
    def denoiser(x, nlf):
        return (x * 0.5 + np.float32(nlf["a"])).astype(np.float32)

    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    dnd.denoise_srgb(denoiser, dnd_folder, ours, log_fn=lambda *a: None)
    jdnd.denoise_srgb(denoiser, dnd_folder, theirs, log_fn=lambda *a: None)
    dnd.bundle_submissions_srgb(ours)
    jdnd.bundle_submissions_srgb(theirs)
    mats = sorted(ours.glob("*.mat"))
    assert len(mats) == N_IMG * N_BOX
    for m in mats[::37]:
        np.testing.assert_array_equal(
            sio.loadmat(str(m))["Idenoised_crop"],
            sio.loadmat(str(theirs / m.name))["Idenoised_crop"])
    for i in (1, 50):
        a = sio.loadmat(str(ours / "bundled" / f"{i:04d}.mat"))
        b = sio.loadmat(str(theirs / "bundled" / f"{i:04d}.mat"))
        assert a["israw"] == b["israw"] and a["eval_version"] == \
            b["eval_version"]
        for k in range(N_BOX):
            np.testing.assert_array_equal(a["Idenoised"][0, k],
                                          b["Idenoised"][0, k])


@pytest.mark.parametrize("flip", [True, False])
def test_make_denoiser_matches_jax(real_pair, flip):
    """One square crop through the denoising-real demo weights: the port's
    device ensemble (eval/tta.py) against the JAX package's host ensemble,
    atol 1e-5 (the fp32 parity bar)."""
    jr, tr = real_pair
    crop = _rand(61, 24, 24, 3)
    got = dnd.make_denoiser(tr, flip=flip)(crop, None)
    want = jdnd.make_denoiser(jr.restore_batch, flip=flip)(crop, None)
    assert got.dtype == np.float32 and got.shape == (24, 24, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# analysis and profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["denoising-syn", "denoising-real", "sisr"])
def test_calculate_parameters_is_the_jax_count(task):
    """The presets at full width, from the demo weights the JAX package
    loads too."""
    sf = 2 if task == "sisr" else None
    ckpt = {"denoising-syn": SYN, "denoising-real": REAL,
            "sisr": str(ZOO / "virnet_sisr_x2_demo.pth")}[task]
    from virnet_tpu.eval.analysis import calculate_parameters as jcount

    tr = Restorer(task, ckpt_path=ckpt, sf=sf or 2, device="cpu")
    jr = JaxRestorer(task, ckpt_path=ckpt, sf=sf or 2)
    assert analysis.calculate_parameters(tr.model) == jcount(jr.params)
    assert analysis.calculate_parameters(tr.model.state_dict()) == \
        jcount(jr.params)


def _conv_macs(model, x_shape, monkeypatch):
    """Multiply-adds of every convolution of one forward, counted from the
    shapes each F.conv2d / F.conv_transpose2d call sees; and the calls."""
    import torch.nn.functional as F

    macs, calls = [], []
    conv2d, convt = F.conv2d, F.conv_transpose2d

    def counted_conv2d(x, w, *args, **kw):
        y = conv2d(x, w, *args, **kw)
        macs.append(y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y

    def counted_convt(x, w, *args, **kw):
        y = convt(x, w, *args, **kw)
        macs.append(x.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y

    monkeypatch.setattr(F, "conv2d", counted_conv2d)
    monkeypatch.setattr(F, "conv_transpose2d", counted_convt)
    with torch.inference_mode():
        model(torch.zeros(x_shape))
    monkeypatch.undo()
    return sum(macs), len(macs)


def test_calculate_flops_counts_the_convolutions(monkeypatch):
    """denoising-syn at 64^2: model_flops (FlopCounterMode on a meta build)
    equals 2 x the multiply-adds of its 41 convolutions counted from the
    shapes of a CPU forward.  The JAX package's XLA count reads 0.9663 of
    it here: XLA counts only the taps of a 'same' convolution that land
    inside the image (fewer at every border, a large share at RNet's 8^2
    level) and adds the elementwise work, which FlopCounterMode leaves
    out."""
    from virnet_tpu.eval.analysis import calculate_flops as jflops
    from virnet_tpu_torch.models import build_model

    model = build_model("denoising-syn", conv_impl="torch").eval()
    macs, calls = _conv_macs(model, (1, 64, 64, 3), monkeypatch)
    got = analysis.model_flops("denoising-syn", 64, 64)
    assert calls == 41
    assert got == 2 * macs
    jr = JaxRestorer("denoising-syn", ckpt_path=SYN)
    xla = jflops(lambda p, x: jr.model.apply({"params": p}, x)[0], jr.params,
                 jnp.zeros((1, 64, 64, 3)))
    assert 0.96 < xla / got < 0.97, xla / got


def test_measure_time_schedule_and_profiling(tmp_path):
    t = analysis.measure_time(lambda x: x * 2, (torch.ones(64, 64),),
                              num_forward=3)
    assert t > 0
    assert analysis.schedule_preview(lambda s: s * 0.1, 3, 10) == \
        {0: 0.0, 1: 1.0, 2: 2.0}
    from virnet_tpu.eval.analysis import calculate_eta_min as jeta

    assert analysis.calculate_eta_min(100, 1e-4, 1e-6, 99) == \
        jeta(100, 1e-4, 1e-6, 99)
    from virnet_tpu_torch.eval import profiling

    with profiling.trace(tmp_path / "tr") as prof:
        with profiling.annotate("restore"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "tr" / "trace.json").exists()
    assert any(e.key == "restore" for e in prof.key_averages())


# ---------------------------------------------------------------------------
# the four command lines
# ---------------------------------------------------------------------------

def _log_kinds(path):
    """The kinds of line a log holds (the text before the first digit)."""
    import re

    return {re.split(r"[\d:]", line.split(" ", 2)[-1])[0]
            for line in Path(path).read_text().splitlines()}


def test_eval_sidd_cli_writes_what_the_jax_cli_writes(tmp_path):
    """--device cpu on 2x2 blocks of 32^2: the same files (.log, .mat with
    denoised_res of the input's shape and megatime), the same kinds of log
    line, PSNR within 0.01 dB of the JAX command line's."""
    from virnet_tpu.cli.eval_sidd import main as jmain
    from virnet_tpu_torch.cli.eval_sidd import main

    d = _sidd_mats(tmp_path / "sidd", 70)
    common = ["--sidd_dir", str(d), "--ckpt_path", REAL, "--batch", "3"]
    res = main(common + ["--save_dir", str(tmp_path / "ours"), "--device",
                         "cpu"])
    jmain(common + ["--save_dir", str(tmp_path / "theirs")])
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert names == ["sidd_val_flip.log", "sidd_val_flip.mat"]
    a = sio.loadmat(str(tmp_path / "ours" / "sidd_val_flip.mat"))
    b = sio.loadmat(str(tmp_path / "theirs" / "sidd_val_flip.mat"))
    assert a["denoised_res"].shape == b["denoised_res"].shape == \
        (2, 2, 32, 32, 3)
    assert a["denoised_res"].dtype == np.uint8
    assert a["megatime"].item() == res["megatime"] > 0
    assert _log_kinds(tmp_path / "ours" / "sidd_val_flip.log") == \
        _log_kinds(tmp_path / "theirs" / "sidd_val_flip.log")
    text = (tmp_path / "theirs" / "sidd_val_flip.log").read_text()
    jpsnr = float(text.split("PSNR=")[1].split(",")[0])
    assert abs(res["psnr"] - jpsnr) < 0.01
    dev = main(common + ["--device", "cpu", "--device_metrics"])
    assert abs(dev["psnr"] - res["psnr"]) < 1e-3
    np.testing.assert_array_equal(dev["blocks"], res["blocks"])


def test_eval_denoising_syn_cli_writes_what_the_jax_cli_writes(tmp_path):
    """--device cpu, iid, on two small CBSD68 PNGs and one McMaster TIF:
    the same files, the pickle's structure, per-case PSNR within 0.01 dB,
    the same kinds of log line."""
    from virnet_tpu.cli.eval_denoising_syn import main as jmain
    from virnet_tpu_torch.cli.eval_denoising_syn import main

    data = tmp_path / "data"
    _pngs(data / "CBSD68", 71, [(24, 32), (32, 24)])
    _pngs(data / "McMaster", 72, [(24, 24)], ext=".tif")
    common = ["--data_root", str(data), "--noise_type", "iid",
              "--ckpt_path", SYN]
    main(common + ["--save_dir", str(tmp_path / "ours"), "--device", "cpu"])
    jmain(common + ["--save_dir", str(tmp_path / "theirs")])
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    got = pickle.loads((tmp_path / "ours" / "results_iid.pkl").read_bytes())
    want = pickle.loads((tmp_path / "theirs" /
                         "results_iid.pkl").read_bytes())
    assert got.keys() == want.keys() == {"CBSD68", "McMaster"}
    for ds in got:
        assert got[ds].keys() == want[ds].keys()
        for case in got[ds]:
            assert abs(got[ds][case]["psnr"] - want[ds][case]["psnr"]) < 0.01
    assert _log_kinds(tmp_path / "ours" / "denoise_iid.log") == \
        _log_kinds(tmp_path / "theirs" / "denoise_iid.log")


def test_eval_sisr_cli_writes_what_the_jax_cli_writes(tmp_path):
    """--device cpu at x2 on one Set14 BMP and one CBSD68 PNG, with LPIPS
    from a seeded weights file: the same files, the pickle's structure,
    per-kernel PSNR-Y within 0.01 dB and LPIPS within 1e-3 relative (the
    two restorations differ in a few uint8 values; LPIPS itself is held at
    1e-5 by test_lpips_matches_jax)."""
    from virnet_tpu.cli.eval_sisr import main as jmain
    from virnet_tpu_torch.cli.eval_sisr import main

    data = tmp_path / "data"
    _pngs(data / "Set14", 73, [(64, 72)], ext=".bmp")
    _pngs(data / "CBSD68", 74, [(72, 64)])
    wpath = tmp_path / "lpips.pth"
    torch.save(_lpips_weights()["lpips"], wpath)
    common = ["--data_root", str(data), "--sf", "2", "--ckpt_path",
              str(ZOO / "virnet_sisr_x2_demo.pth"), "--lpips_weights",
              str(wpath), "--nlevel", "2.55"]
    try:
        main(common + ["--save_dir", str(tmp_path / "ours"), "--device",
                       "cpu"])
        jmain(common + ["--save_dir", str(tmp_path / "theirs")])
    finally:
        lpips.set_params(None)
        jlpips.set_params(None)
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert names == ["sisr_sf2_nl255.log", "sisr_sf2_nl255.pkl"]
    got = pickle.loads((tmp_path / "ours" / names[1]).read_bytes())
    want = pickle.loads((tmp_path / "theirs" / names[1]).read_bytes())
    assert got.keys() == want.keys() == {"Set14", "CBSD68"}
    for ds in got:
        for rec, ref in zip(got[ds]["per_kernel"], want[ds]["per_kernel"]):
            assert abs(rec["psnr"] - ref["psnr"]) < 0.01
            assert abs(rec["lpips"] - ref["lpips"]) <= 1e-3 * ref["lpips"]
    assert _log_kinds(tmp_path / "ours" / names[0]) == \
        _log_kinds(tmp_path / "theirs" / names[0])


def test_eval_dnd_cli_writes_what_the_jax_cli_writes(dnd_folder, tmp_path):
    """--device cpu --no_flip on the synthetic DND folder (1000 crops of
    8^2 through the denoising-real demo weights): the same per-crop and
    bundled files, crops within 1e-5 of the JAX command line's."""
    from virnet_tpu.cli.eval_dnd import main as jmain
    from virnet_tpu_torch.cli.eval_dnd import main

    common = ["--dnd_dir", str(dnd_folder), "--ckpt_path", REAL,
              "--no_flip"]
    main(common + ["--save_dir", str(tmp_path / "ours"), "--device", "cpu"])
    jmain(common + ["--save_dir", str(tmp_path / "theirs")])
    ours = sorted(p.name for p in (tmp_path / "ours").glob("*.mat"))
    assert ours == sorted(p.name for p in (tmp_path / "theirs").glob("*.mat"))
    assert len(ours) == N_IMG * N_BOX
    assert len(list((tmp_path / "ours" / "bundled").glob("*.mat"))) == N_IMG
    for name in ours[::97]:
        np.testing.assert_allclose(
            sio.loadmat(str(tmp_path / "ours" / name))["Idenoised_crop"],
            sio.loadmat(str(tmp_path / "theirs" / name))["Idenoised_crop"],
            atol=1e-5)
    assert (tmp_path / "ours" / "dnd.log").exists()


def _untimed(tree):
    """``tree`` without its wall-clock readings (``seconds``)."""
    if isinstance(tree, dict):
        return {k: _untimed(v) for k, v in tree.items() if k != "seconds"}
    if isinstance(tree, list):
        return [_untimed(v) for v in tree]
    return tree


def _assert_close_tree(got, want, atol, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_close_tree(got[k], want[k], atol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, atol, f"{path}/{i}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, atol=atol, err_msg=path)


def _mesh_outputs(cli, out):
    """What a run of ``cli`` wrote under ``out``, as arrays and numbers to
    compare (no timings)."""
    if cli == "eval_dnd":
        return {p.name: sio.loadmat(str(p))["Idenoised_crop"]
                for p in sorted(out.glob("*.mat"))}
    if cli == "eval_sidd":
        return sio.loadmat(str(out / "sidd_val_flip.mat"))["denoised_res"]
    return _untimed(pickle.loads(next(out.glob("*.pkl")).read_bytes()))


def _assert_served_alike(cli, got, want):
    """``got`` (an int8 run's outputs, ``_mesh_outputs``) has the form of
    ``want`` (the fp32 run's): the same DND crops in [0, 1], the same SIDD
    block array, or the same table with finite scores."""
    if cli == "eval_dnd":
        assert got.keys() == want.keys() and len(got) == 4
        for k in want:
            assert got[k].shape == want[k].shape
            assert np.isfinite(got[k]).all()
            assert 0.0 <= got[k].min() and got[k].max() <= 1.0
        return
    if cli == "eval_sidd":
        assert got.shape == want.shape and got.dtype == want.dtype
        return

    def leaves(tree, out):
        if isinstance(tree, dict):
            for k in sorted(tree):
                leaves(tree[k], out)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                leaves(v, out)
        elif not isinstance(tree, str):
            out.append(float(tree))
        return out
    flat_got, flat_want = leaves(got, []), leaves(want, [])
    assert len(flat_got) == len(flat_want) > 0
    assert np.isfinite(flat_got).all()


@pytest.mark.parametrize("cli", ["eval_denoising_syn", "eval_sidd",
                                 "eval_sisr", "eval_dnd"])
@pytest.mark.parametrize("flag,title", [(["--mesh"], "multi-device and "
                                         "runtime"),
                                        (["--compute", "int8"],
                                         "the remainder")])
def test_eval_clis_refuse_what_is_not_ported(cli, flag, title, tmp_path,
                                             monkeypatch, request):
    """Nothing is refused any more: the two flags that were (their cases
    keep their ids, ``title`` naming the ROADMAP item each came from) are
    served on small seeded data with the demo weights.  --compute int8:
    each command line writes what it writes in fp32, from W8A8
    convolutions (models/common.conv's int8 gate, counted), its scores
    finite and its images in range.  --mesh: a mesh of CPU devices
    (three; two for DND's one-crop batches, its official 50 x 20 loop cut
    to 2 x 2 through the module's ``range``: the whole loop is
    test_eval_dnd_cli_writes_what_the_jax_cli_writes's) in place of every
    visible card writes what the command line writes without it, with
    per-image convolutions, so that a batch's make-up cannot move a
    denoised value.  The SISR model's other reductions (KNet, the sigma
    pool) are summed in an order that follows the batch's size, so there
    a few uint8 values may differ: its scores within 1e-3."""
    import importlib

    from virnet_tpu_torch.models import common as tcommon
    from virnet_tpu_torch.train import mesh

    main = importlib.import_module(f"virnet_tpu_torch.cli.{cli}").main
    data = tmp_path / "data"
    if cli == "eval_denoising_syn":
        _pngs(data / "CBSD68", 81, [(24, 32), (24, 32), (32, 24)])
        _pngs(data / "McMaster", 82, [(24, 24)], ext=".tif")
        args = ["--data_root", str(data), "--noise_type", "iid",
                "--ckpt_path", SYN]
    elif cli == "eval_sidd":
        args = ["--sidd_dir", str(_sidd_mats(data, 83, size=16)),
                "--ckpt_path", REAL, "--batch", "3"]
    elif cli == "eval_sisr":
        _pngs(data / "Set14", 84, [(32, 40)], ext=".bmp")
        _pngs(data / "CBSD68", 85, [(40, 32), (40, 32)])
        args = ["--data_root", str(data), "--sf", "2", "--ckpt_path",
                str(ZOO / "virnet_sisr_x2_demo.pth"), "--lpips", "off"]
    else:
        import builtins

        from virnet_tpu_torch.eval import dnd

        monkeypatch.setattr(dnd, "range",
                            lambda n: builtins.range(min(n, 2)),
                            raising=False)
        args = ["--dnd_dir", str(request.getfixturevalue("dnd_folder")),
                "--ckpt_path", REAL, "--no_flip"]
    size = 2 if cli == "eval_dnd" else 3
    monkeypatch.setattr(mesh, "make_mesh",
                        lambda devices=None: mesh.Mesh(["cpu"] * size))
    quantized = []
    w8a8 = tcommon.conv_w8a8
    monkeypatch.setattr(tcommon, "conv_w8a8", lambda *a, **k: (
        quantized.append(1), w8a8(*a, **k))[1])
    outs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the tier-1 run has six workers at once
    try:
        with _per_image_convs():
            for mode in ([], flag):
                out = tmp_path / f"out{len(outs)}"
                main(args + mode + ["--save_dir", str(out), "--device",
                                    "cpu"])
                outs.append(_mesh_outputs(cli, out))
    finally:
        torch.set_num_threads(threads)
    if flag != ["--mesh"]:
        assert quantized, "no convolution ran W8A8"
        _assert_served_alike(cli, outs[1], outs[0])
        return
    assert not quantized
    if cli == "eval_dnd":
        assert len(outs[0]) == 4
    if cli == "eval_sisr":
        _assert_close_tree(outs[1], outs[0], 1e-3)
    else:
        np.testing.assert_equal(outs[1], outs[0])
    log = next((tmp_path / "out1").glob("*.log")).read_text()
    assert f"data-parallel eval over {size} devices" in log
