"""The port's multi-device serving against the JAX package on the CPU:
eval/spatial.py's row-sharded restores on a mesh of four CPU devices
against the JAX functions on four devices of the virtual CPU mesh
(tests/conftest.py) and against the port's whole-image forward,
``Restorer(mesh=)``'s data-parallel batches, and the demo's ``--mesh``
and ``--rows_shard``.  Small seeded models of the presets
(test_torch_port_shared.small_pair)."""

import jax
import numpy as np
import pytest
import torch

from test_torch_port_shared import small_kwargs, small_pair
from virnet_tpu.eval import spatial as jspatial
from virnet_tpu.eval.engine import Restorer as JaxRestorer
from virnet_tpu.train.mesh import make_mesh as jax_make_mesh
from virnet_tpu_torch.eval import spatial
from virnet_tpu_torch.eval.engine import Restorer
from virnet_tpu_torch.train.mesh import Mesh

CPU4 = Mesh(["cpu"] * 4)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the tier-1 run has six workers at
    once, and PyTorch's default of a thread per core oversubscribes the
    CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _jax_mesh(n=4):
    return jax_make_mesh(jax.devices()[:n])


@pytest.mark.parametrize("h,n,halo,unit", [
    (256, 8, 12, 4), (483, 4, 24, 1), (484, 4, 24, 4), (160, 3, 7, 8),
    (40, 8, 32, 4), (64, 2, 16, 16), (65, 2, 3, 4), (1536, 4, 160, 8)])
def test_plan_strips_is_the_jax_plan(h, n, halo, unit):
    """The same plan, or the same refusal (too short; height not on the
    unit grid)."""
    try:
        want = jspatial.plan_strips(h, n, halo, unit)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).split(" ")[0]):
            spatial.plan_strips(h, n, halo, unit)
        return
    assert spatial.plan_strips(h, n, halo, unit) == want


def _whole(tm, x, *args):
    with torch.inference_mode():
        return tm(torch.from_numpy(x)[None], *args)[0][0].numpy()


def test_restore_rows_sharded_matches_jax_and_the_whole_image():
    """483x61 (odd: RNet's pad and an overhanging last strip) on four
    devices, halo 48: within 1e-5 of the JAX function on four devices
    and of the port's whole-image forward; a 40-row image falls back to
    the whole-image forward; halo 0 really diverges."""
    jm, params, tm, _ = small_pair("denoising-syn", seed=2)
    img = _img(3, 483, 61, 3)
    got = spatial.restore_rows_sharded(tm, img, CPU4, halo=48)
    want = jspatial.restore_rows_sharded(jm, params, img, _jax_mesh(),
                                         halo=48)
    whole = _whole(tm, img)
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, whole, atol=1e-5)
    short = _img(4, 40, 61, 3)
    np.testing.assert_allclose(
        spatial.restore_rows_sharded(tm, short, CPU4, halo=48),
        _whole(tm, short), atol=1e-6)
    bad = spatial.restore_rows_sharded(tm, img, CPU4, halo=0)
    assert np.abs(bad - whole).max() > 1e-4


@pytest.mark.parametrize("noise_avg", [True, False], ids=["avg", "map"])
def test_sr_restore_rows_sharded_matches_jax(noise_avg):
    """x2 of a 123x29 LR image on four devices, halo 40: within 1e-5 of
    the JAX function and of the port's whole-image forward, with the
    sigma pool over the stitched map (``noise_avg``) or the full sigma
    map; a short image falls back; halo 0 diverges."""
    jm, params, tm, _ = small_pair("sisr", seed=5, noise_avg=noise_avg)
    lr = _img(6, 123, 29, 3)
    got = spatial.sr_restore_rows_sharded(tm, lr, 2, CPU4, halo=40)
    want = jspatial.sr_restore_rows_sharded(jm, params, lr, 2, _jax_mesh(),
                                            halo=40)
    whole = _whole(tm, lr, 2)
    assert got.shape == (246, 58, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, whole, atol=1e-5)
    short = _img(7, 20, 29, 3)
    np.testing.assert_allclose(
        spatial.sr_restore_rows_sharded(tm, short, 2, CPU4, halo=40),
        _whole(tm, short, 2), atol=1e-6)
    bad = spatial.sr_restore_rows_sharded(tm, lr, 2, CPU4, halo=0)
    assert np.abs(bad - whole).max() > 1e-4


@pytest.mark.parametrize("task", ["denoising-syn", "sisr"])
def test_restorer_on_a_mesh_matches_no_mesh(task):
    """Restorer(mesh=[cpu] * 3): restore_batch of 7 images (repeat-padded
    to 9, three chunks) within 1e-6 of the engine without a mesh, TTA and
    restore_images the same; restore_image_sharded within 1e-5 of the JAX
    Restorer's, gray input too (gray_mean)."""
    jm, params, _, sd = small_pair(task, seed=8)
    kw = small_kwargs(task)
    plain = Restorer(task, state_dict=sd, sf=2, device="cpu", **kw)
    meshed = Restorer(task, state_dict=sd, sf=2, device="cpu",
                      mesh=Mesh(["cpu"] * 3), gray_mean=True, **kw)
    x = _img(9, 7, 20, 24, 3)
    np.testing.assert_allclose(meshed.restore_batch(x).numpy(),
                               plain.restore_batch(x).numpy(), atol=1e-6)
    im = x[0]
    np.testing.assert_allclose(meshed.restore_image_tta(im),
                               plain.restore_image_tta(im), atol=1e-6)
    ims = [x[1], x[2, :16], x[3], x[4, :, :20, 0]]
    for a, b in zip(meshed.restore_images(ims, batch_size=2),
                    plain.restore_images(ims, batch_size=2)):
        assert a.shape[:2] == b.shape[:2]
        np.testing.assert_allclose(a, b[..., :a.shape[-1]] if a.ndim == 3
                                   else b.mean(axis=2), atol=1e-6)
    jr = JaxRestorer(task, params=params, sf=2, gray_mean=True, **kw)
    big = _img(10, 201, 23, 3)
    for im in (big, big[..., 1]):
        got = meshed.restore_image_sharded(im, CPU4, halo=48)
        want = jr.restore_image_sharded(im, _jax_mesh(), halo=48)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("compute", ["bf16", "int8"])
@pytest.mark.parametrize("task", ["denoising-syn", "sisr"])
def test_restorer_sharded_runs_fp32_in_every_compute(task, compute):
    """Restorer(compute=c).restore_image_sharded on four CPU devices (201 x
    23, halo 48) runs the strips in fp32, as the JAX engine's sharded
    stages do whatever its compute: within 1e-5 of the JAX
    Restorer(compute=c)'s, and the fp32 engine's bits."""
    jm, params, _, sd = small_pair(task, seed=8)
    kw = small_kwargs(task)
    big = _img(10, 201, 23, 3)
    got = Restorer(task, state_dict=sd, sf=2, device="cpu", compute=compute,
                   **kw).restore_image_sharded(big, CPU4, halo=48)
    want = JaxRestorer(task, params=params, sf=2, compute=compute,
                       **kw).restore_image_sharded(big, _jax_mesh(), halo=48)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    fp32 = Restorer(task, state_dict=sd, sf=2, device="cpu", **kw)
    np.testing.assert_array_equal(
        got, fp32.restore_image_sharded(big, CPU4, halo=48))


def _demo_pngs(folder, n=3, shape=(24, 28)):
    import cv2

    folder.mkdir()
    rng = np.random.default_rng(11)
    for i in range(n):
        cv2.imwrite(str(folder / f"im{i}.png"),
                    (rng.random((*shape, 3)) * 255).astype(np.uint8))
    return folder


def test_demo_mesh_and_rows_shard_write_what_the_plain_demo_writes(
        tmp_path, monkeypatch):
    """The demo on a folder of three same-shape images with the denoising
    demo weights: --mesh (three CPU devices in place of every visible
    card: folder batches of 2 split over them) and --rows_shard (a mesh
    of one CPU device: each image falls back to the whole-image forward)
    write the plain demo's PNGs; --rows_shard with --flip or --mesh is
    refused."""
    import cv2

    from virnet_tpu_torch.cli.demo import main
    from virnet_tpu_torch.train import mesh as mesh_mod

    src = _demo_pngs(tmp_path / "in")
    common = ["--task", "denoising-syn", "--in_path", str(src),
              "--device", "cpu"]
    main(common + ["--out_path", str(tmp_path / "plain")])
    main(common + ["--out_path", str(tmp_path / "rows"), "--rows_shard"])
    monkeypatch.setattr(mesh_mod, "make_mesh",
                        lambda devices=None: Mesh(["cpu"] * 3))
    main(common + ["--out_path", str(tmp_path / "mesh"), "--mesh",
                   "--batch_size", "2"])
    names = sorted(p.name for p in (tmp_path / "plain").iterdir())
    assert len(names) == 3
    for out in ("rows", "mesh"):
        assert sorted(p.name for p in (tmp_path / out).iterdir()) == names
        for name in names:
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / out / name)),
                cv2.imread(str(tmp_path / "plain" / name)))
    for bad in (["--flip"], ["--mesh"]):
        with pytest.raises(SystemExit, match="--rows_shard"):
            main(common + ["--out_path", str(tmp_path / "x"),
                           "--rows_shard"] + bad)
