"""Offline data preparation of the port (data/prepare.py, data/isp.py,
data/h5_bench.py) against the JAX package's, on the CPU.

Both sides are host numpy, cv2, scipy and h5py on the same seeded images
written into ``tmp_path``, so every comparison is bit for bit:
assert_array_equal on arrays and decoded pixels, == on names, configs,
lists and dicts.  float64 ``exp``/``pow`` run in the same numpy on both
sides, so they need no tolerance either."""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
from scipy.io import loadmat

from virnet_tpu.data import h5_bench as jh5
from virnet_tpu.data import isp as jisp
from virnet_tpu.data import prepare as jprep
from virnet_tpu_torch.data import h5_bench, isp, prepare
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)


def _images(folder, seed, shapes, ext="png"):
    """Seeded uint8 images (smooth plus noise) written with cv2; returns
    their paths in order."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, shape in enumerate(shapes):
        h, w = shape[:2]
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = 127 + 90 * np.sin(xx / 6.0 + i) * np.cos(yy / 9.0)
        if len(shape) == 3:
            smooth = smooth[..., None]
        im = smooth + rng.normal(0, 12, shape)
        paths.append(str(folder / f"im{i}.{ext}"))
        cv2.imwrite(paths[-1], np.clip(im, 0, 255).astype(np.uint8))
    return paths


def _same_tree(a: Path, b: Path):
    """The same relative file names under both folders, every image
    decoding to the same pixels and every other file to the same bytes;
    returns the number of files."""
    names_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    names_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert names_a == names_b and names_a
    for rel in names_a:
        if rel.suffix == ".png":
            ia = cv2.imread(str(a / rel), cv2.IMREAD_UNCHANGED)
            ib = cv2.imread(str(b / rel), cv2.IMREAD_UNCHANGED)
            assert ia is not None and ia.dtype == ib.dtype
            np.testing.assert_array_equal(ia, ib)
        elif rel.suffix == ".mat":
            ma, mb = loadmat(a / rel), loadmat(b / rel)
            keys = sorted(k for k in ma if not k.startswith("__"))
            assert keys == sorted(k for k in mb if not k.startswith("__"))
            for k in keys:
                np.testing.assert_array_equal(ma[k], mb[k])
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return len(names_a)


# ---------------------------------------------------------------------------
# patch crops and camera pairs
# ---------------------------------------------------------------------------

def test_crop_hr_patches_is_the_jax_packages(tmp_path):
    """Strided crops, the last row and column at the border, the same
    names and pixels (two threads, images of two sizes)."""
    src = _images(tmp_path / "src", 0, [(70, 90, 3), (64, 101, 3)])
    n = prepare.crop_hr_patches(src, tmp_path / "port", pch_size=48,
                                stride=32, max_workers=2)
    m = jprep.crop_hr_patches(src, tmp_path / "jax", pch_size=48, stride=32,
                              max_workers=2)
    assert n == m == _same_tree(tmp_path / "port", tmp_path / "jax")


def test_crop_sidd_patches_is_the_jax_packages(tmp_path):
    """Random patch pairs from a scene seed each: the same names and
    pixels in noisy/ and gt/."""
    noisy = _images(tmp_path / "noisy", 1, [(80, 80, 3), (72, 90, 3)])
    gt = _images(tmp_path / "gt", 2, [(80, 80, 3), (72, 90, 3)])
    pairs = list(zip(noisy, gt))
    n = prepare.crop_sidd_patches(pairs, tmp_path / "port", pch_size=32,
                                  num_patch_per_img=5, seed=7, max_workers=2)
    m = jprep.crop_sidd_patches(pairs, tmp_path / "jax", pch_size=32,
                                num_patch_per_img=5, seed=7, max_workers=2)
    assert n == m == 10
    assert _same_tree(tmp_path / "port", tmp_path / "jax") == 20


@pytest.mark.parametrize("kind", ["rgb", "gray", "alpha"])
def test_synth_camera_pairs_is_the_jax_packages(tmp_path, kind):
    """Camera-noise pairs from an RGB, a gray and an RGBA source set (with
    one image too small to use): the same result, training PNGs and
    validation .mats."""
    shape = {"rgb": (64, 70, 3), "gray": (64, 70), "alpha": (64, 70, 4)}[kind]
    src = _images(tmp_path / "src", 3, [shape] * 6 + [(20, 20, 3)])
    kw = dict(pch_size=32, patches_per_img=2, n_val_imgs=2, n_val_blocks=2,
              seed=5)
    got = prepare.synth_camera_pairs(src, tmp_path / "port", **kw)
    want = jprep.synth_camera_pairs(src, tmp_path / "jax", **kw)
    assert got["n_train"] == want["n_train"] > 0
    assert got["val_shape"] == want["val_shape"] == (2, 2, 32, 32, 3)
    _same_tree(tmp_path / "port", tmp_path / "jax")


# ---------------------------------------------------------------------------
# kernel bank, noise-benchmark HDF5, lists
# ---------------------------------------------------------------------------

def test_make_kernel_bank_is_the_jax_packages(tmp_path):
    """The same kernels and kinfos per sf, in memory and in the .mat."""
    got = prepare.make_kernel_bank(tmp_path / "port.mat", sfs=(2, 3, 4),
                                   k_size=15)
    want = jprep.make_kernel_bank(tmp_path / "jax.mat", sfs=(2, 3, 4),
                                  k_size=15)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    mat = loadmat(tmp_path / "port.mat")
    for k in want:
        np.testing.assert_array_equal(mat[k], want[k])
    assert prepare.make_kernel_bank(None, sfs=(2,), k_size=15).keys() == {
        "kernels_sf2", "kinfos_sf2"}


def _read_all(reader_cls, path):
    with reader_cls(path) as r:
        return [(name, noisy, gt, sigma) for name, noisy, gt, sigma in r]


def test_write_noise_benchmark_h5_is_the_jax_packages(tmp_path):
    """Six case files with the same groups and arrays, read back through
    both readers (each reads both sides' files alike)."""
    src = tmp_path / "ims"
    _images(src, 4, [(40, 50, 3), (33, 29, 3)])
    got = prepare.write_noise_benchmark_h5(src, tmp_path / "port")
    want = jprep.write_noise_benchmark_h5(src, tmp_path / "jax")
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert len(got) == 6
    for g, w in zip(got, want):
        a = _read_all(h5_bench.H5BenchmarkReader, g)
        b = _read_all(jh5.H5BenchmarkReader, w)
        c = _read_all(h5_bench.H5BenchmarkReader, w)
        assert [x[0] for x in a] == [x[0] for x in b] == ["im0", "im1"]
        for ra, rb, rc in zip(a, b, c):
            for xa, xb, xc in zip(ra[1:], rb[1:], rc[1:]):
                assert xa.dtype == xb.dtype == np.float32
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(xc, xb)
        assert a[0][3].shape == (40, 50) and a[0][1].shape == (40, 50, 3)


def test_download_lists_and_verify_corpus_are_the_jax_packages(tmp_path):
    """The URL lists are the same data (nothing fetches); the SIDD filter
    on a seeded URLs file, and verify_corpus on a nested folder."""
    assert prepare.SIDD_BASE_URL == jprep.SIDD_BASE_URL
    assert prepare.TRAIN_CORPORA == jprep.TRAIN_CORPORA
    for args in ((), (["GP", "S6"],), (None, False)):
        assert (prepare.sidd_download_list(*args)
                == jprep.sidd_download_list(*args))
    base = "http://sidd.example/data"
    urls = tmp_path / "SIDD_URLs.txt"
    urls.write_text("".join(f"{base}/{i:04d}_{cam}_{kind}/x{i}.zip\n"
                            for i, (cam, kind) in enumerate(
                                [("GP", "SRGB"), ("GP", "RAW"),
                                 ("S6", "SRGB"), ("IP", "SRGB"),
                                 ("G4", "RAW")])))
    for srgb in (True, False):
        got = prepare.sidd_download_list(["S6", "GP", "G4"], srgb, str(urls))
        assert got == jprep.sidd_download_list(["S6", "GP", "G4"], srgb,
                                               str(urls))
        assert got
    for names in (None, ["DIV2K_train_HR", "WED"]):
        assert (prepare.corpus_download_list(names)
                == jprep.corpus_download_list(names))
    d = tmp_path / "div2k" / "nested"
    d.mkdir(parents=True)
    for i in range(12):
        (d / f"{i:04d}.png").touch()
    for name in ("DIV2K_train_HR", "CBSD432"):
        assert (prepare.verify_corpus(d.parent, name)
                == jprep.verify_corpus(d.parent, name))


# ---------------------------------------------------------------------------
# the camera ISP
# ---------------------------------------------------------------------------

def _smooth(seed, h=34, w=46):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 0.5 + 0.3 * np.sin(yy / 11.0) * np.cos(xx / 7.0)
    im = np.stack([base * 0.9, base, base * 0.8], axis=-1)
    return np.clip(im + rng.normal(0, 0.02, im.shape), 0.0, 1.0)


def test_mosaic_and_demosaics_are_the_jax_packages():
    im = _smooth(0)
    cfa = isp.mosaic_rggb(im)
    np.testing.assert_array_equal(cfa, jisp.mosaic_rggb(im))
    np.testing.assert_array_equal(isp.demosaic_malvar(cfa),
                                  jisp.demosaic_malvar(cfa))
    np.testing.assert_array_equal(isp.demosaic_bilinear(cfa),
                                  jisp.demosaic_bilinear(cfa))
    x = np.linspace(0.0, 1.0, 101)
    for f in ("_srgb_to_linear", "_linear_to_srgb"):
        np.testing.assert_array_equal(getattr(isp, f)(x),
                                      getattr(jisp, f)(x))
    for f in ("_tone_forward", "_tone_inverse"):
        np.testing.assert_array_equal(getattr(isp, f)(x, 1.2, 0.6),
                                      getattr(jisp, f)(x, 1.2, 0.6))


@pytest.mark.parametrize("seed", [0, 11])
def test_camera_isp_is_the_jax_packages(tmp_path, seed):
    """Equal configs (and their JSON), simulate_clean with both demosaics
    and without the tone curve, process(unprocess(x))."""
    im = _smooth(seed + 1)
    a, b = isp.CameraISP(), jisp.CameraISP()
    a.reset_seed(seed)
    b.reset_seed(seed)
    assert json.dumps(a.random_config()) == json.dumps(b.random_config())
    a.save_config(tmp_path / "a.json")
    b.save_config(tmp_path / "b.json")
    assert (tmp_path / "a.json").read_bytes() == (
        tmp_path / "b.json").read_bytes()
    for kw in ({}, {"demosaic_method": "bilinear"}, {"tone_type": "none"}):
        np.testing.assert_array_equal(a.simulate_clean(im, **kw),
                                      b.simulate_clean(im, **kw))
    np.testing.assert_array_equal(a.process(a.unprocess(im)),
                                  b.process(b.unprocess(im)))
    c = isp.CameraISP()
    assert c.load_config(tmp_path / "b.json") == b.config
    assert isp.ISP is isp.CameraISP


def test_isp_process_patches_is_the_jax_packages(tmp_path):
    """The serial path (max_workers=1): the same images and meta files."""
    src = tmp_path / "hr"
    _images(src, 6, [(32, 32, 3), (30, 36, 3), (32, 32, 3)])
    n = isp.isp_process_patches(src, tmp_path / "port", max_workers=1)
    m = jisp.isp_process_patches(src, tmp_path / "jax", max_workers=1)
    assert n == m == 3
    assert _same_tree(tmp_path / "port", tmp_path / "jax") == 6


def test_prepare_chain_is_the_jax_packages(tmp_path):
    """The whole chain in each package: HR crops -> ISP re-render ->
    kernel bank -> noise-benchmark HDF5 of the ISP images -> its reader;
    every product the same."""
    src = _images(tmp_path / "src", 8, [(60, 76, 3)])
    out = {}
    for name, prep, cam, h5 in (("port", prepare, isp, h5_bench),
                                ("jax", jprep, jisp, jh5)):
        root = tmp_path / name
        n = prep.crop_hr_patches(src, root / "hr", pch_size=40, stride=36,
                                 max_workers=1)
        cam.isp_process_patches(root / "hr", root / "isp", max_workers=1)
        bank = prep.make_kernel_bank(root / "bank.mat", sfs=(4,), k_size=11)
        files = prep.write_noise_benchmark_h5(root / "isp" / "images",
                                              root / "h5")
        out[name] = (n, bank, _read_all(h5.H5BenchmarkReader, files[0]))
    assert out["port"][0] == out["jax"][0] == 4
    _same_tree(tmp_path / "port" / "isp", tmp_path / "jax" / "isp")
    _same_tree(tmp_path / "port" / "hr", tmp_path / "jax" / "hr")
    for k in out["jax"][1]:
        np.testing.assert_array_equal(out["port"][1][k], out["jax"][1][k])
    rows_p, rows_j = out["port"][2], out["jax"][2]
    assert [r[0] for r in rows_p] == [r[0] for r in rows_j]
    assert len(rows_p) == 4
    for rp, rj in zip(rows_p, rows_j):
        for xp, xj in zip(rp[1:], rj[1:]):
            np.testing.assert_array_equal(xp, xj)
