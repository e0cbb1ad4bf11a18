"""The halo-free prologue probe (K8 ``dncnn_head_slabzero``) of the port
against the JAX package's ``dncnn_head_fused(mode='slabzero')`` in Pallas
interpret mode, on the CPU in fp32; the path that runs it
(``denoise_forward_fused(mode='slabzero')``) and the A/B tool
``cli/bench_fused_head``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.models import build_model as jax_build_model
from virnet_tpu.models.fused import \
    denoise_forward_fused as jax_denoise_forward_fused
from virnet_tpu.models.virnet import LOG_MAX, LOG_MIN
from virnet_tpu.ops import pallas_conv as pc
from virnet_tpu_torch.cli import bench_fused_head
from virnet_tpu_torch.convert import from_jax_params
from virnet_tpu_torch.models import VIRNet, build_model
from virnet_tpu_torch.models.fused import denoise_forward_fused
from virnet_tpu_torch.ops import fused_conv as fc


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_model(task, shape, seed):
    model = jax_build_model(task)
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return model, params, x


def _snet_head_params(model, params):
    sp = params["snet"]
    mids = range(1, model.dep_S - 1)
    return (sp["conv1"]["kernel"], sp["conv1"]["bias"],
            [sp[f"mid_{i}"]["kernel"] for i in mids],
            [sp[f"mid_{i}"]["bias"] for i in mids],
            sp["conv_last"]["kernel"], sp["conv_last"]["bias"],
            params["rnet"]["head"]["kernel"], params["rnet"]["head"]["bias"])


def _torch_args(args):
    return [[_t(a) for a in v] if isinstance(v, list) else _t(v)
            for v in args]


@pytest.mark.parametrize("task,shape,rows", [
    ("denoising-syn", (1, 32, 32, 3), 16),
    ("denoising-syn", (1, 32, 48, 3), 8),
    ("denoising-real", (1, 32, 32, 3), 16),
    # two images, so that the second image's first slab reads zeros above
    # it; slabs of 4 (under both depths' L + 3), 8 and 16 rows
    *[(task, (2, 16, 24, 3), rows)
      for task in ("denoising-syn", "denoising-real") for rows in (4, 8, 16)],
])
def test_slabzero_plain_matches_jax_interpret(task, shape, rows):
    """K8's plain version (K3's function on the slab view with x read one
    row up: what K8's kernels compute in both dtypes) against the Pallas
    slabzero kernel in interpret mode with the same HWIO weights: head and
    sigma atol 5e-6, the JAX package's own bar for this kernel (f32 sums
    in another order)."""
    model, params, x = _jax_model(task, shape, 5)
    args = _snet_head_params(model, params)
    head_j, sig_j = pc.dncnn_head_fused(
        jnp.asarray(x), *args, slope=0.25, lmin=LOG_MIN, lmax=LOG_MAX,
        mode="slabzero", rows=rows, interpret=True)
    got = []
    for fn in (fc.dncnn_head_slabzero_plain, fc.dncnn_head_slabzero):
        head, sig = fn(_t(x), *_torch_args(args), rows=rows, slope=0.25,
                       lmin=LOG_MIN, lmax=LOG_MAX)
        assert head.shape == (*shape[:3], args[6].shape[3])
        np.testing.assert_allclose(head.numpy(), np.asarray(head_j),
                                   atol=5e-6, rtol=0)
        np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j),
                                   atol=5e-6, rtol=0)
        got.append(head)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(*got)


def test_slab_rows_up_is_the_shifted_slab_view():
    """What the kernels read for K8 (x one row up in memory, zero in row -1
    of every image) is the plain version's shifted and re-sliced x."""
    x = torch.arange(2 * 8 * 3 * 2, dtype=torch.float32).reshape(2, 8, 3, 2)
    up = fc.slab_rows_up(x, 4)
    assert up.shape == (4, 4, 3, 2)
    zero = torch.zeros(3, 2)
    assert torch.equal(up[0, 0], zero) and torch.equal(up[2, 0], zero)
    for slab in range(4):
        img, y0 = divmod(slab * 4, 8)
        for r in range(4):
            if y0 + r > 0:        # row y0 + r reads row y0 + r - 1
                assert torch.equal(up[slab, r], x[img, y0 + r - 1])


def test_slabzero_interior_is_the_true_prologue_one_row_up():
    """What the probe's wrongness is: farther than L+3 rows from every
    slab edge its output equals the true prologue's (K3's function)
    shifted down one row; at a slab's first rows it does not."""
    rng = np.random.default_rng(1)
    L, rows, h = 2, 16, 32

    def w(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32) * 0.1)

    args = [w(3, 3, 3, 64), w(64), [w(3, 3, 64, 64) for _ in range(L)],
            [w(64) for _ in range(L)], w(3, 3, 64, 1), w(1), w(3, 3, 4, 16),
            w(16)]
    x = _t(rng.random((1, h, 24, 3), dtype=np.float32))
    head, sig = fc.dncnn_head_slabzero(x, *args, rows=rows)
    head_true, sig_true = fc.dncnn_head_fused(x, *args)
    for t in range(h // rows):
        lo, hi = t * rows + L + 3, (t + 1) * rows - (L + 3)
        torch.testing.assert_close(head[:, lo:hi], head_true[:, lo - 1:hi - 1],
                                   atol=1e-5, rtol=0)
        torch.testing.assert_close(sig[:, lo:hi], sig_true[:, lo - 1:hi - 1],
                                   atol=0, rtol=1e-5)
    assert float((head[:, rows] - head_true[:, rows - 1]).abs().max()) > 1e-3


def test_denoise_forward_fused_slabzero_matches_jax():
    """The path as a whole: the JAX denoise_forward_fused(mode='slabzero',
    interpret=True) against the port's with the converted weights.  mu atol
    1e-5, sigma atol 5e-6; 'carry' and 'halo' are one kernel here."""
    model, params, x = _jax_model("denoising-syn", (1, 32, 32, 3), 2)
    mu_j, sig_j = jax_denoise_forward_fused(
        model, params, jnp.asarray(x), interpret=True, mode="slabzero",
        rows=16)
    port = build_model("denoising-syn")
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)),
                         strict=True)
    port.eval()
    with torch.no_grad():
        mu, sig = denoise_forward_fused(port, _t(x), mode="slabzero", rows=16)
        mu_h, sig_h = denoise_forward_fused(port, _t(x), mode="halo")
        mu_c, sig_c = denoise_forward_fused(port, _t(x), mode="carry",
                                            rows=16)
        mu_m, _ = port(_t(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=5e-6,
                               rtol=0)
    assert torch.equal(mu_h, mu_c) and torch.equal(sig_h, sig_c)
    # the model's own forward stays on K3's function, not the probe's
    assert torch.equal(mu_m, mu_h)
    assert float((mu - mu_h).abs().max()) > 1e-4


def test_slabzero_raises_on_bad_rows_mode_and_grad():
    port = VIRNet(sigma_chn=1, n_feat=(16, 24, 32), dep_S=3).eval()
    x = torch.rand(1, 32, 32, 3)
    with torch.no_grad():
        with pytest.raises(ValueError, match="must divide"):
            denoise_forward_fused(port, x, mode="slabzero", rows=12)
        with pytest.raises(ValueError, match="must divide"):
            denoise_forward_fused(port, x[:, :24], mode="slabzero")
        with pytest.raises(ValueError, match="halo\\|carry\\|slabzero"):
            denoise_forward_fused(port, x, mode="column")
        mu, _ = denoise_forward_fused(port, x, mode="slabzero")   # rows=32
        assert mu.shape == x.shape
    with pytest.raises(RuntimeError, match="forward-only"):
        denoise_forward_fused(port, x, mode="slabzero", rows=16)
    assert "dncnn_head_slabzero" in fc.LAUNCHES


def test_bench_fused_head_runs_on_the_cpu():
    """The A/B tool at 2x32^2 with a narrow model: one time per variant
    and repetition, no kernel launch on the CPU, errors not swallowed."""
    narrow = dict(n_feat=(16, 24, 32), dep_S=3, n_resblocks=1)
    variants = ["unfused", "halo", "carry:r16", "slabzero:r8",
                "slabzero:r16+tail", "unfused+tail"]
    res = bench_fused_head.run(variants, batch=2, size=32, reps=2, chain=2,
                               device="cpu", compute="fp32", **narrow)
    assert list(res) == variants
    for r in res.values():
        assert len(r["ms"]) == 2 and all(m > 0 for m in r["ms"])
        assert r["best_ms"] == min(r["ms"]) and r["mp_per_s"] > 0
        assert r["launches"] == {}
    assert bench_fused_head.parse_variant("slabzero:r16+tail") == (
        "slabzero:r16+tail", "slabzero", 16, True)
    with pytest.raises(ValueError, match="must divide"):
        bench_fused_head.run(["slabzero:r12"], batch=1, size=32, reps=1,
                             device="cpu", compute="fp32", **narrow)
    with pytest.raises(ValueError, match="unknown variant"):
        bench_fused_head.run(["column"], batch=1, size=32, device="cpu")
    with pytest.raises(ValueError, match="fused prologue"):
        bench_fused_head.run(["halo"], batch=1, size=30, device="cpu",
                             compute="fp32", **narrow)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_fused_head.run(["unfused"], batch=1, size=32)


def test_bench_fused_head_main_prints_a_line_per_variant(capsys):
    # the preset at full width, one tiny image
    bench_fused_head.main(["--variants", "halo,slabzero:r16", "--batch", "1",
                           "--size", "32", "--reps", "1", "--chain", "1",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert "halo: ms/apply" in out and "slabzero:r16: ms/apply" in out
