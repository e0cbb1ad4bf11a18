"""The port's serving layer (virnet_tpu_torch/eval, cli, ops I/O) against
the JAX package's, on the CPU in fp32, plus the port's import hygiene and
its refusal to run on the CPU unasked."""

import ast
import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.eval.engine import Restorer as JaxRestorer
from virnet_tpu.eval.tiling import forward_chop as jax_forward_chop
from virnet_tpu.ops.augment import dihedral_inverse_np as jax_dinv
from virnet_tpu.ops.augment import dihedral_np as jax_d
from virnet_tpu_torch.eval.engine import Restorer
from virnet_tpu_torch.eval.tiling import bucket_size, forward_chop
from virnet_tpu_torch.ops.augment import dihedral_inverse_np, dihedral_np
from test_torch_port_card import DEMO_CKPTS, SERVING_PATHS
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
SYN = str(ROOT / "model_zoo" / "virnet_denoising_syn_demo.pth")


@pytest.fixture(scope="module")
def restorers():
    return (JaxRestorer("denoising-syn", ckpt_path=SYN),
            Restorer("denoising-syn", ckpt_path=SYN, device="cpu"))


def _im(seed, h, w):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


def test_restore_image_odd_size(restorers):
    jr, tr = restorers
    im = _im(0, 29, 35)
    np.testing.assert_allclose(tr.restore_image(im), jr.restore_image(im),
                               atol=1e-5)


def test_restore_image_tta(restorers):
    jr, tr = restorers
    im = _im(1, 20, 28)
    np.testing.assert_allclose(tr.restore_image_tta(im),
                               jr.restore_image_tta(im), atol=1e-5)


def test_restore_images_groups_shapes(restorers):
    jr, tr = restorers
    ims = [_im(2, 24, 32), _im(3, 29, 35), _im(4, 24, 32)[..., 0]]
    for a, b in zip(tr.restore_images(ims, batch_size=2),
                    jr.restore_images(ims, batch_size=2)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_pad_buckets_match_jax():
    jr = JaxRestorer("denoising-syn", ckpt_path=SYN, pad_multiple=16)
    tr = Restorer("denoising-syn", ckpt_path=SYN, pad_multiple=16,
                  device="cpu")
    im = _im(5, 21, 30)
    np.testing.assert_allclose(tr.restore_image(im), jr.restore_image(im),
                               atol=1e-5)


def test_forward_chop_and_buckets_match_jax():
    x = np.random.default_rng(6).random((1, 37, 50, 3), dtype=np.float32)

    def fwd(t):   # any per-pixel map that tells tiles apart
        return t * 2.0 + 1.0

    want = jax_forward_chop(fwd, jnp.asarray(x), shave=3, min_size=200)
    got = forward_chop(fwd, torch.from_numpy(x), shave=3, min_size=200)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [bucket_size(n, m) for n, m in ((37, 16), (64, 16), (5, 0))] \
        == [48, 64, 5]


def test_dihedral_matches_jax():
    im = _im(7, 5, 7)
    for m in range(8):
        np.testing.assert_array_equal(dihedral_np(im, m), jax_d(im, m))
        np.testing.assert_array_equal(dihedral_inverse_np(dihedral_np(im, m),
                                                          m), im)
        np.testing.assert_array_equal(dihedral_inverse_np(im, m),
                                      jax_dinv(im, m))


def test_demo_cli_writes_restored_png(tmp_path):
    from virnet_tpu_torch.cli.demo import main

    im = (_im(8, 29, 35) * 255).round().astype(np.uint8)
    src = tmp_path / "noisy.png"
    cv2.imwrite(str(src), im)
    main(["--task", "denoising-syn", "--in_path", str(src), "--out_path",
          str(tmp_path / "out"), "--ckpt_path", SYN, "--device", "cpu"])
    out = cv2.imread(str(tmp_path / "out" / "restored_noisy.png"))
    assert out is not None and out.shape == (29, 35, 3)
    rgb = cv2.cvtColor(im, cv2.COLOR_BGR2RGB).astype(np.float32) / 255
    want = Restorer("denoising-syn", ckpt_path=SYN, device="cpu") \
        .restore_image(rgb)
    want = np.rint(np.clip(want, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(cv2.cvtColor(out, cv2.COLOR_BGR2RGB),
                                  want)


def test_demo_cli_serves_int8(tmp_path):
    """--compute int8 writes what Restorer(compute='int8') restores (the
    demo weights, the plain versions on the CPU); with --rows_shard it
    writes what --rows_shard in fp32 writes, since the strips run fp32 in
    every compute, and the port's int8 engine restores sharded within
    1e-5 of the JAX int8 engine's (here one CPU device: the whole-image
    fp32 forward on both sides)."""
    import jax

    from virnet_tpu.train.mesh import make_mesh as jax_make_mesh
    from virnet_tpu_torch.cli.demo import main
    from virnet_tpu_torch.train.mesh import make_mesh

    im = (_im(10, 20, 24) * 255).round().astype(np.uint8)
    src = tmp_path / "noisy.png"
    cv2.imwrite(str(src), im)
    args = ["--task", "denoising-syn", "--in_path", str(src), "--ckpt_path",
            SYN, "--device", "cpu"]
    main(args + ["--out_path", str(tmp_path / "out"), "--compute", "int8"])
    out = cv2.imread(str(tmp_path / "out" / "restored_noisy.png"))
    rgb = cv2.cvtColor(im, cv2.COLOR_BGR2RGB).astype(np.float32) / 255
    want = Restorer("denoising-syn", ckpt_path=SYN, device="cpu",
                    compute="int8").restore_image(rgb)
    want = np.rint(np.clip(want, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(cv2.cvtColor(out, cv2.COLOR_BGR2RGB),
                                  want)
    main(args + ["--out_path", str(tmp_path / "rows8"), "--compute", "int8",
                 "--rows_shard"])
    main(args + ["--out_path", str(tmp_path / "rows32"), "--rows_shard"])
    rows8 = cv2.imread(str(tmp_path / "rows8" / "restored_noisy.png"))
    np.testing.assert_array_equal(
        rows8, cv2.imread(str(tmp_path / "rows32" / "restored_noisy.png")))
    assert not np.array_equal(rows8, out)
    got = Restorer("denoising-syn", ckpt_path=SYN, device="cpu",
                   compute="int8").restore_image_sharded(
        rgb, make_mesh(["cpu"]))
    jax_want = JaxRestorer("denoising-syn", ckpt_path=SYN, compute="int8") \
        .restore_image_sharded(rgb, jax_make_mesh(jax.devices()[:1]))
    np.testing.assert_allclose(got, jax_want, atol=1e-5)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    sisr = Restorer("sisr", ckpt_path=ROOT / "model_zoo" /
                    "virnet_sisr_x4_demo.pth", sf=4, device="cpu")
    out = sisr.restore_image(_im(9, 11, 13))
    assert out.shape == (44, 52, 3) and np.isfinite(out).all()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Restorer("denoising-syn", ckpt_path=SYN)


@pytest.mark.parametrize("case", list(SERVING_PATHS))
def test_serving_paths_call_exactly_their_kernels(case, monkeypatch):
    """The released serving paths of SERVING_PATHS (test_torch_port_card.py)
    on the CPU, with the card's device gate open and at a small size of the
    same kind (a pad-free 32^2 batch, an odd 21 x 27 image): one request
    calls exactly the path's kernel wrappers, each running its plain
    version (K1 inside K2 is part of K2's plain version and not counted),
    and launches nothing."""
    from virnet_tpu_torch.models import attresunet
    from virnet_tpu_torch.ops import fused_conv as fc
    from virnet_tpu_torch.ops import resblock

    task, compute, shape, want = SERVING_PATHS[case]
    calls = {}

    def record(module, name):
        real = getattr(module, name)

        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, call)

    monkeypatch.setattr(attresunet, "_on_card", lambda x: True)
    for module, name in ((fc, "dncnn_head_fused"), (fc, "dncnn_fused"),
                         (attresunet, "conv3x3_tail_residual"),
                         (resblock, "resblock_conv")):
        record(module, name)
    r = Restorer(task, ckpt_path=DEMO_CKPTS[task], compute=compute,
                 device="cpu")
    fc.reset_launches()
    if len(shape) == 4:
        out = r.restore_batch(_im(33, 32, 32)[None])
        assert out.shape == (1, 32, 32, 3)
    else:
        out = r.restore_image(_im(33, 21, 27))
        assert out.shape == (21, 27, 3)
    assert np.isfinite(np.asarray(out)).all()
    assert calls == {k: n for k, n in want.items() if k != "conv3x3_mid"}
    assert not any(fc.LAUNCHES.values())


# ------------------------------------------ the Restorer's host copies

def _request(r, entry, x):
    """(numpy-in result, tensor-in result) of one request: ``restore_batch``
    of the batch ``x``, or ``restore_image`` of its first image on the
    quadrant-chop path against ``forward_chop`` of ``restore_batch`` on a
    tensor (the chop's own forward, ``pad_multiple=0``)."""
    if entry == "batch":
        return r.restore_batch(x), r.restore_batch(torch.from_numpy(x))
    got = r.restore_image(x[0])
    want = forward_chop(r.restore_batch, torch.from_numpy(x[:1]),
                        shave=10, min_size=1000)[0]
    return got, want


@pytest.mark.parametrize("entry", ["batch", "chop"])
@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_cpu_numpy_and_tensor_requests_agree_and_copy_nothing(
        entry, compute, monkeypatch):
    """On the CPU a numpy request and a tensor request give the same bits,
    both on the host, and ``COPIES`` stays zero: nothing is pinned or
    copied.  ``chop`` lowers the quadrant-chop threshold so that a 40 x
    44 image takes that path (one split)."""
    from virnet_tpu_torch.eval import engine

    monkeypatch.setattr(engine, "CHOP_THRESHOLD", 1000)
    r = Restorer("denoising-syn", ckpt_path=SYN, compute=compute,
                 device="cpu")
    x = np.random.default_rng(25).random((2, 40, 44, 3), dtype=np.float32)
    got, want = _request(r, entry, x)
    assert want.device.type == "cpu"
    if entry == "batch":
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        got = got.numpy()
    else:
        assert isinstance(got, np.ndarray) and got.shape == (40, 44, 3)
    np.testing.assert_array_equal(got, want.numpy())
    assert engine.COPIES == dict.fromkeys(engine.COPIES, 0)


def _metric_reader(name):
    import importlib.util

    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name,missing", [
    ("copy_out_host_ms.serve", "no span"),
    ("pinned_copy_pct.serve", "no counter"),
    ("pinned_copy_pct.serve", "nothing counted"),
])
def test_copy_readers_read_none_where_the_program_has_nothing(
        name, missing, monkeypatch):
    """The readers of the copy-out span and of ``COPIES`` give None where
    the program has no ``engine.copy_out`` span, no ``COPIES`` (a program
    from before them) or counted no copy, and the page-locked share of
    what ``COPIES`` counted on the card (never off it)."""
    import types

    from virnet_tpu_torch.eval import engine, profiling

    read = _metric_reader(name)
    card = types.SimpleNamespace(device=torch.device("cuda"))
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    if missing == "no span":
        monkeypatch.setattr(profiling, "records", lambda: [
            profiling.Record(0, "engine.restore_batch", None, 0, 0, 10),
            profiling.Record(1, "engine.copy_in", 0, 0, 0, 4)])
        assert read(card) is None and read(cpu) is None
        monkeypatch.setattr(profiling, "records", lambda: [
            profiling.Record(0, "engine.restore_batch", None, 0, 0, 10 ** 7),
            profiling.Record(1, "engine.copy_out", 0, 0, 10 ** 6,
                             4 * 10 ** 6)])
        assert read(card) == pytest.approx(3.0)
        return
    if missing == "no counter":
        monkeypatch.delattr(engine, "COPIES")
        assert read(card) is None
        return
    monkeypatch.setattr(engine, "COPIES", dict.fromkeys(engine.COPIES, 0))
    assert read(card) is None
    engine.COPIES.update(pinned_in=3, pinned_out=2, pageable_in=1)
    assert read(card) == pytest.approx(100.0 * 5 / 6)
    assert read(cpu) is None


FORBIDDEN = ("jax", "flax", "virnet_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib\n"
        "mods = ['virnet_tpu_torch', 'virnet_tpu_torch.eval.engine',\n"
        "        'virnet_tpu_torch.cli.demo', 'virnet_tpu_torch.convert',\n"
        "        'virnet_tpu_torch.models.fused', 'chip_smoke',\n"
        "        'virnet_tpu_torch.cli.train_sisr',\n"
        "        'virnet_tpu_torch.train.loop_sisr',\n"
        "        'virnet_tpu_torch.losses.elbo',\n"
        "        'virnet_tpu_torch.data.sisr_synth',\n"
        "        'virnet_tpu_torch.data.sources',\n"
        "        'virnet_tpu_torch.eval.metrics',\n"
        "        'virnet_tpu_torch.data.eval_sets',\n"
        "        'virnet_tpu_torch.ops.sigma_fields',\n"
        "        'virnet_tpu_torch.ops.degrade',\n"
        "        'virnet_tpu_torch.cli.train_denoising_syn',\n"
        "        'virnet_tpu_torch.cli.train_denoising_real',\n"
        "        'virnet_tpu_torch.train.mesh',\n"
        "        'virnet_tpu_torch.train.resilience',\n"
        "        'virnet_tpu_torch.eval.spatial',\n"
        "        'virnet_tpu_torch.cli.resilience_proof',\n"
        "        'virnet_tpu_torch.cli.endurance',\n"
        "        'virnet_tpu_torch.ops.qconv',\n"
        "        'virnet_tpu_torch.cli.export_torch',\n"
        "        'virnet_tpu_torch.cli.parity']\n"
        "for m in mods: importlib.import_module(m)\n"
        # the demo's SISR path, driven on a tiny image on the CPU
        "import tempfile, cv2, numpy as np\n"
        "from virnet_tpu_torch.cli.demo import main\n"
        "d = tempfile.mkdtemp()\n"
        "cv2.imwrite(d + '/a.png', np.full((9, 11, 3), 99, np.uint8))\n"
        "main(['--task', 'sisr', '--sf', '3', '--in_path', d + '/a.png',\n"
        "      '--out_path', d, '--device', 'cpu'])\n"
        "assert cv2.imread(d + '/restored_a.png').shape == (27, 33, 3)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'virnet_tpu')"
        " or m.startswith(('jax.', 'flax.', 'virnet_tpu.'))]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax():
    files = sorted((ROOT / "virnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            assert not any(_forbidden(n) for n in names), (f, names)
