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


def test_bench_restore_times_restore_image_and_needs_the_card():
    """cli/bench_restore: its timer drives ``restore_image`` (here on the
    CPU, at a small odd size); its command line measures the card only."""
    from virnet_tpu_torch.cli import bench_restore

    cpu = Restorer("denoising-syn", ckpt_path=SYN, device="cpu")
    res = bench_restore.time_image(cpu, np.random.default_rng(0).random(
        (13, 15, 3), dtype=np.float32), reps=2, warmup=1)
    assert len(res["ms"]) == 2 and 0 < res["min_ms"] <= res["median_ms"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        bench_restore.main(["--size", "13x15"])


def test_bench_restore_takes_the_sisr_task_and_its_flags():
    """cli/bench_restore --task sisr --sf N [--profile] [--cudnn]: the
    flags parse, the default weights are the scale's demo checkpoint, and
    its timer drives a SISR ``restore_image`` (here on the CPU, at a small
    size)."""
    from virnet_tpu_torch.cli import bench_restore

    args = bench_restore.build_parser().parse_args(
        ["--task", "sisr", "--sf", "3", "--profile", "--compute", "fp32"])
    assert (args.task, args.sf, args.profile, args.compute) == \
        ("sisr", 3, True, "fp32")
    assert not bench_restore.build_parser().parse_args([]).profile
    assert not bench_restore.build_parser().parse_args([]).cudnn
    assert bench_restore.build_parser().parse_args(["--cudnn"]).cudnn
    with pytest.raises(SystemExit):
        bench_restore.build_parser().parse_args(["--sf", "5"])
    ckpt = bench_restore.default_ckpt("sisr", 3)
    assert ckpt.name == "virnet_sisr_x3_demo.pth" and ckpt.exists()
    assert bench_restore.default_ckpt("denoising-syn", 3).exists()
    cpu = Restorer("sisr", ckpt_path=ckpt, sf=3, device="cpu")
    res = bench_restore.time_image(cpu, _im(10, 9, 11), reps=2, warmup=1)
    assert len(res["ms"]) == 2 and 0 < res["min_ms"] <= res["median_ms"]


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
        "        'virnet_tpu_torch.cli.bench_restore',\n"
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
