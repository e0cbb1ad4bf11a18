"""JPEG degradation and the input pipeline of the port against the JAX
package on the CPU: the quality tables, ``jpeg_degrade`` (the tie rule
below), its distance from cv2's libjpeg, the JPEG branch of the SISR
synthesis, the host JPEG sampler, the pack files, the LMDB converter, the
device-resident sampler, the prefetcher, and the trainers and their CLIs
on device data, pack files and both JPEG routes.

The tie rule: where a DCT coefficient over its table entry lies exactly
on k + 0.5, two correct float32 sums may round it to different bins, and
that moves one 8x8 luma block, or one chroma MCU and the chroma samples
next to it that the fancy upsample reads, by a quantization step; where a
decoded value lies on k + 0.5, its pixel may land one level apart in that
channel.  Every pixel where the two packages differ must lie in such a
block (a coefficient whose coef / table, in float64, is within 1e-3 of
k + 0.5), or differ by one level in channels whose decoded value is
within 1e-3 of k + 0.5; every other pixel must be bit-equal on the 1/255
grid.  The inputs are seeded synthetic images (an upsampled random field
plus noise): no data set is in the repo.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from virnet_tpu.data import device_data as jdd
from virnet_tpu.data import packdb as jpack
from virnet_tpu.data import sisr_host as jhost
from virnet_tpu.data.sources import ImageCache as JaxImageCache
from virnet_tpu.ops import jpeg as jjpeg
from virnet_tpu_torch.data import device_data as tdd
from virnet_tpu_torch.data import lmdb_convert, packdb, sisr_host, sisr_synth
from virnet_tpu_torch.data.prefetch import DevicePrefetcher
from virnet_tpu_torch.data.sources import ImageCache
from virnet_tpu_torch.ops import jpeg
from virnet_tpu_torch.ops.color import jpeg_compress
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)

SISR_SMALL = dict(n_feat=(16, 24, 32), dep_S=3, dep_K=2, n_resblocks=1,
                  batch_size=2, hr_size=32, sf=2, k_size=5,
                  mixed_precision=False, print_freq=1)
DENOISE_SMALL = dict(n_feat=(16, 24, 32), dep_S=3, n_resblocks=1,
                     batch_size=2, patch_size=24, mixed_precision=False,
                     print_freq=1)


def natural(rng, n, h, w):
    """Seeded natural-like images: a cubic-upsampled random field (8x)
    plus Gaussian noise of std 0.05, clipped to [0, 1]."""
    field = rng.random((n, h // 8 + 2, w // 8 + 2, 3))
    up = ndi.zoom(field, (1, 8, 8, 1), order=3)[:, :h, :w]
    return np.clip(up + rng.normal(0, 0.05, up.shape), 0, 1).astype(
        np.float32)


def assert_tie_rule(x, qf, subsample, got, want):
    """Every differing pixel is explained by a tie (module docstring); the
    rest are bit-equal on the 1/255 grid.  Returns the share of pixels
    that differ."""
    x, qf, got, want = (torch.tensor(a) for a in (x, qf, got, want))
    bad = jpeg._untied(x, qf, got, want, subsample)
    assert not bad.any(), f"{int(bad.sum())} pixels differ outside a tie"
    for out in (got, want):
        assert torch.equal(torch.round(out * 255) / 255, out)
    # the rule must leave most of the image to the bit-equal check
    blocks, values = jpeg._ties(x, qf, subsample)
    assert blocks.double().mean() < 0.5 and values.double().mean() < 0.01
    return float((got != want).any(-1).double().mean())


# ------------------------------------------------------------- JPEG codec

def test_quality_tables_are_bit_equal_to_jax():
    qs = np.arange(1, 101, dtype=np.float32)
    for got, want in zip(jpeg.quality_tables(torch.from_numpy(qs)),
                         jjpeg.quality_tables(jnp.asarray(qs))):
        assert got.shape == (100, 8, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for q in (1, 31, 49, 50, 75.0, 100):
        for got, want in zip(jpeg.quality_tables(q),
                             jjpeg.quality_tables(q)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("subsample", [True, False])
@pytest.mark.parametrize("n,h,w", [(16, 48, 48), (4, 37, 53), (2, 128, 128)])
def test_jpeg_degrade_matches_jax_under_the_tie_rule(n, h, w, subsample):
    rng = np.random.default_rng(h * w + subsample)
    x = natural(rng, n, h, w)
    qf = rng.integers(30, 96, n).astype(np.float32)
    got = jpeg.jpeg_degrade(torch.from_numpy(x), torch.from_numpy(qf),
                            subsample=subsample)
    assert got.shape == x.shape and got.dtype == torch.float32
    want = np.asarray(jjpeg.jpeg_degrade(x, jnp.asarray(qf),
                                         subsample=subsample))
    share = assert_tie_rule(x, qf, subsample, got.numpy(), want)
    assert share < 0.05, share


def test_jpeg_degrade_per_sample_quality_and_leading_dims():
    x = natural(np.random.default_rng(3), 2, 32, 40)
    batched = jpeg.jpeg_degrade(torch.from_numpy(x), torch.tensor([20., 80.]))
    for i, q in enumerate((20.0, 80.0)):
        assert torch.equal(batched[i],
                           jpeg.jpeg_degrade(torch.from_numpy(x[i]), q))
    # TF32 flags do not reach the codec (no matmul in it)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(jpeg.jpeg_degrade(torch.from_numpy(x),
                                             torch.tensor([20., 80.])),
                           batched)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("qf", [10, 30, 50, 75, 90])
def test_jpeg_degrade_is_close_to_libjpeg(qf):
    """The JAX package's bars (tests/test_jpeg.py): mean abs error under
    1.5/255 and under 0.55x the codec's own error."""
    im = natural(np.random.default_rng(qf), 1, 128, 128)[0]
    real = jpeg_compress(im, qf, chn_in="rgb").astype(np.float32)
    mine = jpeg.jpeg_degrade(torch.from_numpy(im), float(qf)).numpy()
    mad_model = np.abs(mine - real).mean()
    mad_clean = np.abs(im - real).mean()
    assert mad_model < 0.55 * mad_clean, (qf, mad_model, mad_clean)
    assert mad_model < 1.5 / 255.0, (qf, mad_model)


# ---------------------------------------------------- the SISR JPEG branch

def _synth_draws(g, n, sf, lr_shape):
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    return dict(lam1=u(0.2, sf), lam2_u=u(0, 1), iso_u=u(0, 1),
                theta=u(0, np.pi), nlevel=u(0.1 / 255, 15 / 255),
                noise=torch.randn(lr_shape, generator=g))


def test_sisr_jpeg_branch_matches_jax_codec_on_the_ports_lr():
    n, sf = 8, 2
    g = torch.Generator().manual_seed(4)
    hr = torch.from_numpy(natural(np.random.default_rng(4), n, 48, 48))
    draws = _synth_draws(g, n, sf, (n, 24, 24, 3))
    draws.update(is_jpeg=torch.tensor([1, 0] * 4, dtype=torch.bool),
                 nlevel_jpeg=torch.full((n,), 3 / 255),
                 qf=torch.tensor([30., 45, 60, 95, 31, 70, 80, 35]))
    got = sisr_synth.synthesize_sisr_batch(hr, sf, 7, add_jpeg=True,
                                           draws=draws)
    std = torch.where(draws["is_jpeg"], draws["nlevel_jpeg"],
                      draws["nlevel"])
    assert torch.equal(got.nlevel.view(-1), std)
    pre = torch.clamp(got.im_blur + draws["noise"] * std.view(n, 1, 1, 1),
                      0, 1).numpy()
    want = np.where(draws["is_jpeg"].numpy()[:, None, None, None],
                    np.asarray(jjpeg.jpeg_degrade(
                        pre, jnp.asarray(draws["qf"].numpy()))), pre)
    jp = draws["is_jpeg"].numpy()
    np.testing.assert_array_equal(got.im_lr.numpy()[~jp], want[~jp])
    assert_tie_rule(pre[jp], draws["qf"].numpy()[jp], True,
                    got.im_lr.numpy()[jp], want[jp])


def test_gaussian_only_draws_are_unchanged_and_qf_in_the_table():
    """Without add_jpeg the generator is drawn as before the JPEG branch:
    the kernel draws, the std, the noise, in that order."""
    n, sf = 4, 2
    hr = torch.from_numpy(natural(np.random.default_rng(5), n, 32, 32))
    a = sisr_synth.synthesize_sisr_batch(
        hr, sf, 5, generator=torch.Generator().manual_seed(9))
    b = sisr_synth.synthesize_sisr_batch(
        hr, sf, 5, draws=_synth_draws(torch.Generator().manual_seed(9), n,
                                      sf, (n, 16, 16, 3)))
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    qf = sisr_synth.random_qf_device(4000, "cpu",
                                     torch.Generator().manual_seed(0))
    assert torch.equal(qf, torch.round(qf))
    assert float(qf.min()) >= 30 and float(qf.max()) <= 95
    host = {sisr_host.random_qf(np.random.default_rng(i)) for i in range(500)}
    assert host <= set(qf.int().tolist())
    assert host == {jhost.random_qf(np.random.default_rng(i))
                    for i in range(500)}


# --------------------------------------------------------- host JPEG sampler

@pytest.fixture(scope="module")
def hr_pngs(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("hr")
    rng = np.random.default_rng(0)
    for i, shape in enumerate(((48, 56), (40, 40), (64, 48))):
        cv2.imwrite(str(d / f"im{i}.png"),
                    (natural(rng, 1, *shape)[0] * 255).astype(np.uint8))
    return sorted(str(p) for p in d.glob("*.png"))


@pytest.mark.parametrize("add_jpeg", [True, False])
def test_host_sisr_sampler_is_bit_equal_to_jax(hr_pngs, add_jpeg):
    kw = dict(k_size=7, add_jpeg=add_jpeg, seed=3)
    mine = sisr_host.HostSISRSampler(ImageCache(hr_pngs), 32, 2, **kw)
    theirs = jhost.HostSISRSampler(JaxImageCache(hr_pngs), 32, 2, **kw)
    for reseed in (None, 7):
        if reseed is not None:
            mine.reset_seed(reseed)
            theirs.reset_seed(reseed)
        a, b = mine.sample(6), theirs.sample(6)
        assert a.im_lr.shape == (6, 16, 16, 3)
        for name in ("im_hr", "im_lr", "kinfo", "nlevel"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)


# ------------------------------------------------------------ pack files

def test_packdb_files_and_batches_match_jax(tmp_path, monkeypatch):
    build = tmp_path / "build"
    monkeypatch.setenv("VIRNET_TPU_TORCH_BUILD_DIR", str(build))
    monkeypatch.setattr(packdb, "_lib", None)
    rng = np.random.default_rng(0)
    noisy = rng.integers(0, 256, (5, 40, 36, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (5, 40, 36, 3), dtype=np.uint8)
    ours, theirs = tmp_path / "ours.vpk", tmp_path / "theirs.vpk"
    packdb.write_packdb(ours, noisy, gt)
    jpack.write_packdb(theirs, noisy, gt)
    assert ours.read_bytes() == theirs.read_bytes()
    for a, b in ((packdb.read_packdb_arrays(theirs), (noisy, gt)),
                 (jpack.read_packdb_arrays(ours), (noisy, gt))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    mine = packdb.PackDBSampler(ours, 16, seed=7)
    other = jpack.PackDBSampler(theirs, 16, seed=7)
    assert len(mine) == 5 and mine.paired and mine.rec_shape == (40, 36, 3)
    for raw in (True, False, True):
        for x, y in zip(mine.sample(8, raw=raw), other.sample(8, raw=raw)):
            np.testing.assert_array_equal(x, y)
    mine.close()
    other.close()
    # the library lands in the port's build directory, nowhere else
    assert [p.name for p in build.iterdir()] == [packdb.library_path().name]
    single = tmp_path / "single.vpk"
    packdb.write_packdb(single, noisy)
    s = packdb.PackDBSampler(single, 8, seed=1)
    assert not s.paired and s.sample(4).shape == (4, 8, 8, 3)
    s.close()


def test_packdb_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("VIRNET_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(packdb, "_lib", None)
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(packdb, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        packdb.get_library()
    assert not list(tmp_path.glob("*.so"))


class _FakeCursor:
    def __init__(self, d):
        self._d = d

    def __enter__(self):
        return iter(sorted(self._d.items()))

    def __exit__(self, *a):
        return False


class _FakeTxn(_FakeCursor):
    def __enter__(self):
        return self

    def cursor(self):
        return _FakeCursor(self._d)

    def get(self, key):
        return self._d.get(key)


def test_lmdb_to_packdb_through_a_stub(tmp_path, monkeypatch):
    from virnet_tpu.data.lmdb_convert import lmdb_to_packdb as jax_convert

    rng = np.random.default_rng(3)
    db, pairs = {}, []
    for i in range(4):
        noisy, gt = (rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
                     for _ in range(2))
        db[f"sidd_{i:04d}_noisy".encode()] = noisy.tobytes()
        db[f"sidd_{i:04d}_gt".encode()] = gt.tobytes()
        pairs.append((noisy, gt))
    db[b"renoir_0000_noisy"] = db[b"sidd_0000_noisy"]
    db[b"renoir_0000_gt"] = db[b"sidd_0000_gt"]
    mod = types.ModuleType("lmdb")
    mod.open = lambda path, **kw: types.SimpleNamespace(
        begin=lambda write=False: _FakeTxn(db), close=lambda: None)
    monkeypatch.setitem(sys.modules, "lmdb", mod)

    out = tmp_path / "out.vpk"
    assert lmdb_convert.lmdb_to_packdb("db", out) == 4
    noisy, gt = packdb.read_packdb_arrays(out)
    np.testing.assert_array_equal(noisy, np.stack([p[0] for p in pairs]))
    np.testing.assert_array_equal(gt, np.stack([p[1] for p in pairs]))
    assert jax_convert("db", tmp_path / "j.vpk") == 4
    assert (tmp_path / "j.vpk").read_bytes() == out.read_bytes()
    lmdb_convert.main(["--lmdb_dir", "db", "--out", str(tmp_path / "m.vpk"),
                       "--datasets", "sidd", "renoir"])
    assert packdb.read_packdb_arrays(tmp_path / "m.vpk")[0].shape[0] == 5
    assert lmdb_convert._infer_shape(12 * 12 * 3) == (12, 12, 3)
    assert lmdb_convert._infer_shape(9) == (3, 3, 1)
    with pytest.raises(ValueError, match="cannot infer"):
        lmdb_convert._infer_shape(10)
    with pytest.raises(ValueError, match="no 'noisy' keys"):
        lmdb_convert.lmdb_to_packdb("db", tmp_path / "x.vpk", ("polyu",))
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="lmdb"):
        lmdb_convert.lmdb_to_packdb("db", tmp_path / "y.vpk")


# ------------------------------------------------------------ device data

def _records(n=6, h=32, w=40, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def test_sample_patches_is_bit_equal_to_jax_on_the_same_draws():
    recs = _records()
    g = torch.Generator().manual_seed(2)
    draws = dict(idx=torch.randint(0, 6, (16,), generator=g),
                 oh=torch.randint(0, 32 - 16 + 1, (16,), generator=g),
                 ow=torch.randint(0, 40 - 16 + 1, (16,), generator=g),
                 mode=torch.arange(16) % 8)
    gt = 255 - recs
    got, got_gt = tdd.sample_patches(torch.from_numpy(recs), 16, 16,
                                     extra=torch.from_numpy(gt), draws=draws)
    assert got.dtype == torch.uint8 and got.shape == (16, 16, 16, 3)
    d = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in draws.items()}
    for mine, source in ((got, recs), (got_gt, gt)):
        crops = jax.vmap(jdd._crop_one, in_axes=(0, 0, 0, None))(
            jnp.asarray(source)[d["idx"]], d["oh"], d["ow"], 16)
        want = jax.vmap(jdd.dihedral_traced)(crops, d["mode"])
        np.testing.assert_array_equal(mine.numpy(), np.asarray(want))
    # paired crops share their draws: the gt crop is 255 - the noisy one
    assert torch.equal(got_gt, 255 - got)
    # dihedral_traced alone, per-sample modes
    x = torch.from_numpy(recs[:, :24, :24])
    mode = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7][:6])
    np.testing.assert_array_equal(
        tdd.dihedral_traced(x, mode).numpy(),
        np.asarray(jax.vmap(jdd.dihedral_traced)(
            jnp.asarray(recs[:, :24, :24]), jnp.asarray(mode.numpy()))))
    with pytest.raises(ValueError, match="square"):
        tdd.dihedral_traced(torch.from_numpy(recs), mode)


def test_sample_patches_from_a_generator():
    recs = torch.from_numpy(_records(4, 16, 16))
    a = tdd.sample_patches(recs, 12, 16, augment=False,
                           generator=torch.Generator().manual_seed(0))
    b = tdd.sample_patches(recs, 12, 16, augment=False,
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    # patch == record and no augmentation: whole records come back
    for im in a:
        assert any(torch.equal(im, r) for r in recs)


def test_records_from_images_and_the_dataset(hr_pngs):
    got = tdd.records_from_images(hr_pngs, 44, per_image=3, seed=5)
    want = jdd.records_from_images(hr_pngs, 44, per_image=3, seed=5)
    assert got.shape == (9, 44, 44, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    ds = tdd.DeviceDataset(got, device="cpu")
    assert (ds.num_records, ds.rec_shape, ds.paired) == (9, (44, 44, 3),
                                                         False)
    assert len(ds.arrays) == 1 and ds.nbytes == got.nbytes
    ds.refresh(255 - got)
    assert ds.arrays[0].shape == (9, 44, 44, 3)
    assert torch.equal(ds.arrays[0], torch.from_numpy(255 - got))
    with pytest.raises(ValueError, match="shape"):
        ds.refresh(got[:4])
    with pytest.raises(ValueError, match="pairedness"):
        ds.refresh(got, got)
    with pytest.raises(ValueError, match="uint8"):
        tdd.DeviceDataset(got.astype(np.float32), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdd.DeviceDataset(got)


# ------------------------------------------------------------ prefetcher

def test_prefetcher_order_values_pytrees_errors_and_close():
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
               for _ in range(7)]
    with DevicePrefetcher(iter(batches), "cpu", depth=2) as pf:
        out = list(pf)
    assert len(out) == 7 and pf.stats["batches"] == 7
    for got, want in zip(out, batches):
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)
    assert set(pf.stats) == {"sample_s", "put_s", "block_s", "batches"}

    trees = [sisr_host.HostSISRBatch(b, b[:, ::2, ::2], b[:, 0, 0],
                                     b[:, 0, 0, :1]) for b in batches[:2]]
    trees += [(b, {"gt": b + 1}, [b]) for b in batches[2:4]]
    got = list(DevicePrefetcher(iter(trees), "cpu"))
    assert isinstance(got[0], sisr_host.HostSISRBatch)
    np.testing.assert_array_equal(got[1].im_lr.numpy(), trees[1].im_lr)
    np.testing.assert_array_equal(got[3][1]["gt"].numpy(), batches[3] + 1)
    assert isinstance(got[2][2], list)

    def failing():
        yield batches[0]
        raise RuntimeError("sampler exploded")

    pf = DevicePrefetcher(failing(), "cpu", depth=2)
    next(pf)
    with pytest.raises(RuntimeError, match="sampler exploded"):
        next(pf)

    def endless():
        while True:
            yield batches[0]

    pf = DevicePrefetcher(endless(), "cpu", depth=1)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter(batches), "cpu", depth=0)


def test_prefetched_training_is_bitwise_equal(tmp_path):
    """The prefetcher changes nothing a step sees: the same parameters
    after an epoch with and without it."""
    from virnet_tpu_torch.train.loop_denoise import (DenoiseTrainConfig,
                                                     DenoiseTrainer)

    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (2, 24, 24, 3), dtype=np.uint8)
               for _ in range(3)]

    def run(prefetch):
        tr = DenoiseTrainer(DenoiseTrainConfig(
            save_dir=str(tmp_path / str(prefetch)), prefetch=prefetch,
            steps_per_epoch=3, **DENOISE_SMALL), device="cpu")
        stats = tr.train_epoch(0, iter(batches), log_fn=lambda m: None)
        assert tr.step == 3
        assert stats.get("prefetch_batches", 3) == 3
        return tr.model.state_dict()

    a, b = run(0), run(2)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------ trainers on device data

def _sisr_trainer(tmp_path, name, host=False, **kw):
    from virnet_tpu_torch.train.loop_sisr import (SISRTrainConfig,
                                                  SISRTrainer)

    return SISRTrainer(SISRTrainConfig(save_dir=str(tmp_path / name),
                                       **dict(SISR_SMALL, **kw)),
                       device="cpu", host_batches=host)


def _denoise_trainer(tmp_path, name, real):
    from virnet_tpu_torch.train.loop_denoise import (DenoiseTrainConfig,
                                                     DenoiseTrainer)

    return DenoiseTrainer(DenoiseTrainConfig(save_dir=str(tmp_path / name),
                                             **DENOISE_SMALL),
                          real=real, device="cpu")


@pytest.mark.parametrize("kind", ["sisr", "sisr_jpeg", "syn", "real"])
def test_run_step_device_is_reproducible_and_resumes_exactly(kind, tmp_path):
    recs = _records(6, 40, 40)
    paired = kind == "real"
    ds = tdd.DeviceDataset(recs, (255 - recs) if paired else None,
                           device="cpu")

    def make(name):
        if kind.startswith("sisr"):
            return _sisr_trainer(tmp_path, name,
                                 add_jpeg_in_graph=kind == "sisr_jpeg")
        return _denoise_trainer(tmp_path, name, real=paired)

    a, b = make("a"), make("b")
    for _ in range(3):
        out = a.run_step_device(ds, 0)
        assert all(np.isfinite(float(v)) for v in out.values())
    for _ in range(2):
        b.run_step_device(ds, 0)
    b.save(0)
    c = make("b")
    assert c.restore() == 1 and c.step == 2
    c.run_step_device(ds, 0)
    again = make("again")
    again.train_epoch_device(0, ds, 3, log_fn=lambda m: None)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, c.model.state_dict()[k]), k
        assert torch.equal(v, again.model.state_dict()[k]), k
    other = tdd.DeviceDataset(recs, None if paired else recs, device="cpu")
    if not kind.startswith("sisr"):
        with pytest.raises(ValueError, match="paired"):
            a.run_step_device(other, 0)


def test_sisr_device_data_refuses_host_batches(tmp_path):
    tr = _sisr_trainer(tmp_path, "h", host=True)
    ds = tdd.DeviceDataset(_records(2, 40, 40), device="cpu")
    with pytest.raises(ValueError, match="host_batches"):
        tr.run_step_device(ds, 0)


# ------------------------------------------------------------------ CLIs

def _write_cfg(path, text):
    path.write_text("{\n" + text + "\n}")
    return path


_SISR_CFG = """
    "im_chn": 3, "sigma_chn": 1, "hr_size": 32, "batch_size": 2,
    "epochs": 1, "steps_per_epoch": 2, "lr": 2e-4, "print_freq": 1,
    "save_dir": "unused", "dep_S": 3, "dep_K": 2, "n_feat": [16, 24, 32],
    "n_resblocks": 1, "extra_mode": "Both", "sf": 2, "k_size": 5,
    "mixed_precision": false, "noise_level": [0.1, 15],
    "noise_jpeg": [0.1, 10], "device_record_size": 40,
    "device_records_per_image": 2, "train_hr_patchs": "%s", %s"""


@pytest.mark.parametrize("extra,needle", [
    ('"device_data": true', "Device-resident HR records: 6"),
    ('"add_jpeg": true, "jpeg_in_graph": true', "Number of HR patches"),
    ('"add_jpeg": true, "jpeg_in_graph": false, "prefetch": 0',
     "Number of HR patches"),
    ('"add_jpeg": true, "jpeg_in_graph": true, "device_data": true',
     "Device-resident HR records"),
])
def test_sisr_cli_trains_on_the_new_inputs(extra, needle, hr_pngs, tmp_path):
    from pathlib import Path

    from virnet_tpu_torch.cli.train_sisr import main

    cfg = _write_cfg(tmp_path / "c.json",
                     _SISR_CFG % (Path(hr_pngs[0]).parent, extra))
    save = tmp_path / "run"
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu"])
    log = (save / "train.log").read_text()
    assert needle in log and "epoch 1 took" in log
    assert "nan" not in log.split(needle)[1]


def test_sisr_cli_refuses_device_data_with_host_jpeg(hr_pngs, tmp_path):
    from pathlib import Path

    from virnet_tpu_torch.cli.train_sisr import main

    cfg = _write_cfg(tmp_path / "c.json", _SISR_CFG % (
        Path(hr_pngs[0]).parent, '"add_jpeg": true, "device_data": true'))
    with pytest.raises(SystemExit, match="host-side libjpeg"):
        main(["--config", str(cfg), "--save_dir", str(tmp_path / "r"),
              "--device", "cpu"])


_DENOISE_CFG = """
    "im_chn": 3, "sigma_chn": 1, "batch_size": 2, "patch_size": 24,
    "epochs": 1, "steps_per_epoch": 2, "lr": 1e-4, "print_freq": 1,
    "save_dir": "unused", "dep_S": 3, "n_feat": [16, 24, 32],
    "n_resblocks": 1, "mixed_precision": false, %s"""


def test_syn_cli_trains_on_device_data(hr_pngs, tmp_path):
    from pathlib import Path

    from virnet_tpu_torch.cli.train_denoising_syn import main

    cfg = _write_cfg(tmp_path / "c.json", _DENOISE_CFG % (
        '"train_data": [["%s", "*.png"]], "device_data": true, '
        '"device_record_size": 32, "device_records_per_image": 2'
        % Path(hr_pngs[0]).parent))
    save = tmp_path / "run"
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu"])
    log = (save / "train.log").read_text()
    assert "Device-resident GT records: 6" in log and "epoch 1 took" in log


@pytest.mark.parametrize("device_data", [False, True])
def test_real_cli_trains_on_a_pack_file(device_data, tmp_path):
    from virnet_tpu_torch.cli.train_denoising_real import main

    rng = np.random.default_rng(6)
    gt = (natural(rng, 4, 32, 32) * 255).astype(np.uint8)
    noisy = np.clip(gt + rng.normal(0, 10, gt.shape), 0, 255).astype(
        np.uint8)
    pack = tmp_path / "train.vpk"
    packdb.write_packdb(pack, noisy, gt)
    cfg = _write_cfg(tmp_path / "c.json", _DENOISE_CFG % (
        '"train_pch_dir": "%s", "train_pack_file": "%s", '
        '"device_data": %s' % (tmp_path / "none", pack,
                               str(device_data).lower())))
    save = tmp_path / "run"
    main(["--config", str(cfg), "--save_dir", str(save), "--device", "cpu"])
    log = (save / "train.log").read_text()
    assert ("Device-resident records: 4" if device_data
            else "Number of training records (packdb): 4") in log
    assert "epoch 1 took" in log
    if device_data:
        cfg = _write_cfg(tmp_path / "d.json", _DENOISE_CFG % (
            '"train_pch_dir": "x", "device_data": true'))
        with pytest.raises(ValueError, match="train_pack_file"):
            main(["--config", str(cfg), "--save_dir", str(tmp_path / "r2"),
                  "--device", "cpu"])
