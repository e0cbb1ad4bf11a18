"""The port's int8 (W8A8) serving against the JAX package's on the CPU:
ops/qconv.py bit for bit (the int8 activations, the scales, the int32
sums and the float32 output), the gate (the same convolutions quantized,
by count, widths and kernel size), the forward with float32 activations
at a tight bar, ``Restorer(compute='int8')`` at a stated one, its mesh
(scales over the whole batch) and its row-sharded restores (fp32, as the
JAX engine's), K10's and K9's plain versions and K9's weight layout.
Small seeded models of the presets, seeded in torch and carried to the JAX
package by ``convert.to_jax_params``; K9 and K10 themselves run only on
the card (tests/test_torch_port_card.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)
from virnet_tpu import precision as jprecision
from virnet_tpu.eval.engine import Restorer as JaxRestorer
from virnet_tpu.models import build_model as jax_build_model
from virnet_tpu.ops import qconv as jqconv
from virnet_tpu.train.mesh import make_mesh as jax_make_mesh
from virnet_tpu_torch.convert import to_jax_params
from virnet_tpu_torch.eval.engine import Restorer
from virnet_tpu_torch.models import build_model
from virnet_tpu_torch.models import common as tcommon
from virnet_tpu_torch.ops import qconv
from virnet_tpu_torch.precision import int8_convs
from virnet_tpu_torch.train.mesh import Mesh

# small widths where every kind of gated conv occurs: SNet's 64-wide mids,
# RNet body convs at 16 and 24 (and 32), and in the SISR model the SFT
# 1x1 convs 16 -> 64 of the conditioned 64-wide level and KNet's body
SMALL = {"denoising-syn": dict(n_feat=(8, 16, 24), dep_S=3, n_resblocks=1),
         "denoising-real": dict(n_feat=(8, 16, 24, 32), dep_S=3,
                                n_resblocks=1),
         "sisr": dict(n_feat=(16, 64), dep_S=3, dep_K=2, n_resblocks=1)}

# the gated (Ci, Co, k) of each full-width preset, with their counts (the
# SISR gate is the same for sf 2, 3 and 4: the weights do not depend on it)
FULL = {
    "denoising-syn": {(64, 64, 3): 3, (96, 96, 3): 12, (192, 192, 3): 12,
                      (288, 288, 3): 6},
    "denoising-real": {(64, 64, 3): 6, (96, 96, 3): 12, (160, 160, 3): 12,
                       (224, 224, 3): 12, (288, 288, 3): 6},
    "sisr": {(64, 64, 3): 19, (96, 96, 3): 8, (160, 160, 3): 8,
             (224, 224, 3): 4, (24, 96, 1): 8, (20, 40, 1): 4,
             (40, 160, 1): 8, (28, 56, 1): 4, (56, 224, 1): 8},
}


def _img(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# ops/qconv.py, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,ci,co", [(3, 16, 16), (3, 64, 64), (3, 96, 96),
                                     (3, 20, 40), (1, 24, 96), (1, 40, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_w8a8_is_the_jax_function_bit_for_bit(k, ci, co, dtype):
    """The int8 activations and their scales, the folded weight's int8
    values and scales, the int32 sums (the plain float64 product) and the
    float32 output equal the JAX package's, on inputs whose channels span
    a factor of 30 in range; so do the parts the card path takes apart:
    K10's plain version (the absmax) under ``scale_of``, and K9's plain
    version (the float input quantized with those scales, then the int8
    product), which ``conv_q8`` runs on the CPU."""
    rng = np.random.default_rng(k * 1000 + ci + co)
    x = (rng.standard_normal((2, 9, 11, ci))
         * rng.uniform(0.1, 3.0, ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xqj, sxj = jqconv.quantize_symmetric(xj, axes=(0, 1, 2))
    xqt, sxt = qconv.quantize_symmetric(xt, (0, 1, 2))
    np.testing.assert_array_equal(xqt.numpy(), np.asarray(xqj))
    np.testing.assert_array_equal(sxt.numpy(), np.asarray(sxj))
    sx = qconv.scale_of(qconv.absmax_plain(xt))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sxj).reshape(-1))
    np.testing.assert_array_equal(qconv.quantize_with(xt, sx).numpy(),
                                  np.asarray(xqj))
    kqj, swj = jqconv.quantize_symmetric(
        jnp.asarray(w) * sxj.reshape(1, 1, -1, 1), axes=(0, 1, 2))
    kqt, swt = qconv.quantize_symmetric(
        torch.from_numpy(w) * sxt.reshape(1, 1, -1, 1), (0, 1, 2))
    np.testing.assert_array_equal(kqt.numpy(), np.asarray(kqj))
    np.testing.assert_array_equal(swt.numpy(), np.asarray(swj))
    acc = lax.conv_general_dilated(
        xqj, kqj, (1, 1), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(qconv.int32_sums(xqt, kqt, k // 2).numpy(),
                                  np.asarray(acc))
    want = np.asarray(jqconv.conv_w8a8(xj, jnp.asarray(w), jnp.asarray(b)))
    got = qconv.conv_w8a8(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    args = (xt, sx, kqt, swt.reshape(-1), torch.from_numpy(b))
    fused = qconv.conv_q8_plain(*args)
    np.testing.assert_array_equal(fused.numpy(), want)
    assert torch.equal(qconv.conv_q8(*args), fused)


def test_quantize_guards_dead_channels_and_ties():
    """A channel of zeros quantizes to zeros with the 1e-12 / 127 scale;
    values on k + 0.5 levels round half to even, as jnp.round does."""
    x = np.zeros((1, 2, 2, 3), np.float32)
    x[0, 0, 0, 1] = 127.0
    x[0, 0, 1, 1] = 2.5
    x[0, 1, 0, 1] = -3.5
    x[0, :, :, 2] = 1e-30
    q, s = qconv.quantize_symmetric(torch.from_numpy(x), (0, 1, 2))
    qj, sj = jqconv.quantize_symmetric(jnp.asarray(x), axes=(0, 1, 2))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert q[0, 0, 1, 1] == 2 and q[0, 1, 0, 1] == -4
    assert not q[..., 0].any() and torch.isfinite(s).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absmax_plain_is_the_scale_source(dtype):
    """K10's plain version (``absmax_plain``, per channel over N, H, W) is
    the absmax that ``quantize_symmetric`` and the JAX package scale by,
    bit for bit: a dead channel (zeros), a channel whose largest magnitude
    is negative, ties of +-m, a subnormal channel and channels over a wide
    range, in float32 and bfloat16; ``absmax_nhwc`` on the CPU is it."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 5, 7, 6))
         * np.array([1.0, 0.0, 3.0, 1e-3, 250.0, 1.0])).astype(np.float32)
    x[1, 2, 3, 0] = -9.5                   # the largest magnitude negative
    x[0, 0, 0, 2], x[1, 4, 6, 2] = 7.25, -7.25            # a tie of +-m
    x[..., 5] = np.float32(1e-40) * rng.integers(-3, 4, x.shape[:3])
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = qconv.absmax_plain(xt)
    assert got.dtype == torch.float32 and got.shape == (6,)
    _, s = qconv.quantize_symmetric(xt, (0, 1, 2))
    assert torch.equal(qconv.scale_of(got), s.reshape(-1))
    _, sj = jqconv.quantize_symmetric(jnp.asarray(x).astype(dtype),
                                      axes=(0, 1, 2))
    np.testing.assert_array_equal(qconv.scale_of(got).numpy(),
                                  np.asarray(sj).reshape(-1))
    assert torch.equal(got, xt.float().abs().amax((0, 1, 2)))
    assert got[0] == 9.5 and got[1] == 0 and got[2] == 7.25
    assert torch.equal(qconv.absmax_nhwc(xt), got)


@pytest.mark.parametrize("k,ci,co", [(3, 24, 20), (3, 64, 96), (1, 40, 13)])
def test_k9_operands_hold_the_product(k, ci, co):
    """What K9 reads of the weights (ops/qconv.kernel_weights: (Ci32 / 32,
    k*k, Co, 32), the input channels zero-padded to a multiple of 32, each
    output channel's 32 channels of a chunk contiguous) and its
    decomposition (the int32 sums of each 32-channel chunk, added) give
    the plain product bit for bit; K9's function on the CPU is the plain
    one, and dequantizing in bf16 is one rounding of the float32 output."""
    rng = np.random.default_rng(ci + co)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 5, 7, ci),
                                       dtype=np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, (k, k, ci, co),
                                       dtype=np.int8))
    wk = qconv.kernel_weights(kq)
    cip = -(-ci // 32) * 32
    assert wk.shape == (cip // 32, k * k, co, 32) and wk.is_contiguous()
    khwio = wk.permute(1, 0, 3, 2).reshape(k, k, cip, co)
    assert torch.equal(khwio[:, :, :ci], kq) and not khwio[:, :, ci:].any()
    xk = torch.nn.functional.pad(xq, (0, cip - ci))
    chunks = sum(qconv.int32_sums(xk[..., c:c + 32], khwio[:, :, c:c + 32],
                                  k // 2)
                 for c in range(0, cip, 32))
    want = qconv.int32_sums(xq, kq, k // 2)
    assert torch.equal(chunks, want)
    sw = torch.from_numpy(rng.uniform(1e-5, 1e-3, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32))
    ones = torch.ones(ci)
    f32 = qconv.conv_q8(xq.float(), ones, kq, sw, bias)
    assert torch.equal(f32, qconv.conv_s8_plain(xq, kq, sw, bias))
    assert torch.equal(qconv.conv_q8(xq.to(torch.bfloat16), ones, kq, sw,
                                     bias, torch.bfloat16),
                       f32.to(torch.bfloat16))


def test_conv_w8a8_is_forward_only_and_takes_same_convs_only():
    x = torch.rand(1, 4, 4, 16)
    w = torch.rand(3, 3, 16, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        qconv.conv_w8a8(x, w)
    with torch.no_grad():
        with pytest.raises(ValueError, match="stride 1"):
            qconv.conv_w8a8(x, w, stride=2)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def _recording(module, name):
    """Inside the block ``module.<name>`` (a conv_w8a8) records (Ci, Co, k)
    of each call."""
    calls = []
    fn = getattr(module, name)

    def rec(x, kernel, *args, **kwargs):
        calls.append((int(x.shape[-1]), int(kernel.shape[-1]),
                      int(kernel.shape[0])))
        return fn(x, kernel, *args, **kwargs)

    return calls, rec


def _counts(calls):
    out: dict = {}
    for c in calls:
        out[c] = out.get(c, 0) + 1
    return out


def _jax_gated(task, monkeypatch, hw, **overrides):
    """(Ci, Co, k) of each conv_w8a8 call of the JAX forward of ``task``
    under quant_mode('int8'), traced abstractly (the gate reads shapes
    only)."""
    calls, rec = _recording(jqconv, "conv_w8a8")
    monkeypatch.setattr(jqconv, "conv_w8a8", rec)
    jm = jax_build_model(task, **overrides)
    x = jax.ShapeDtypeStruct((1, *hw, 3), jnp.float32)
    args = (2,) if task == "sisr" else ()
    params = jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v,
                                              *args), x)
    with jprecision.quant_mode("int8"):
        jax.eval_shape(lambda p, v: jm.apply(p, v, *args), params, x)
    return calls


@pytest.mark.parametrize("task", ["denoising-syn", "denoising-real", "sisr"])
def test_int8_gate_takes_the_convs_jax_takes(task, monkeypatch):
    """At full width (the port's gate read off the modules) and at small
    widths (the port's forward run), the port quantizes exactly the
    convolutions whose (Ci, Co, k) the JAX gate quantizes, as many times;
    at full width they are ``FULL``'s."""
    with torch.device("meta"):
        full = build_model(task, conv_impl="torch")
    ours = _counts((m.in_channels, m.out_channels, m.kernel_size[0])
                   for m in full.modules() if tcommon.int8_gated(m))
    assert ours == FULL[task]
    assert _counts(_jax_gated(task, monkeypatch, (32, 32))) == FULL[task]

    want = _jax_gated(task, monkeypatch, (16, 20), **SMALL[task])
    calls, rec = _recording(tcommon, "conv_w8a8")
    monkeypatch.setattr(tcommon, "conv_w8a8", rec)
    tm = build_model(task, conv_impl="torch", **SMALL[task]).eval()
    args = (2,) if task == "sisr" else ()
    with torch.inference_mode(), int8_convs(torch.float32):
        tm(torch.from_numpy(_img(4, 1, 16, 20, 3)), *args)
    assert sorted(calls) == sorted(want) and len(calls) >= 5
    assert {c[2] for c in calls} == ({1, 3} if task == "sisr" else {3})


def _pair(task, seed):
    """(JAX model, its params tree, the port's model in fp32 on the CPU
    built with conv_impl='torch', its state dict) of a small ``task``
    preset: seeded torch weights, carried to the JAX tree by
    ``convert.to_jax_params``."""
    torch.manual_seed(seed)
    tm = build_model(task, conv_impl="torch", **SMALL[task]).eval()
    sd = tm.state_dict()
    return (jax_build_model(task, **SMALL[task]),
            to_jax_params(sd)["params"], tm, sd)


@pytest.mark.parametrize("task", ["denoising-syn", "denoising-real", "sisr"])
def test_int8_forward_matches_jax_with_float32_activations(task,
                                                           monkeypatch):
    """The forward with the gated convs W8A8 and everything else in
    float32 (the JAX package's quant_mode('int8') without a compute dtype)
    against the JAX forward.  Each quantized conv, handed the port's own
    input, is the JAX conv_w8a8 bit for bit.  End to end the float convs
    differ in summation order, and an activation on a rounding tie then
    moves one int8 level: the bar is max abs 1e-3 and a mean abs under
    half the quantization's own effect (int8 against fp32)."""
    jm, params, tm, _ = _pair(task, seed=5)
    x = _img(6, 2, 20, 24, 3)
    args = (2,) if task == "sisr" else ()

    def fwd(p, v):
        with jprecision.quant_mode("int8"):
            return jm.apply({"params": p}, v, *args)[0]
    want = np.asarray(jax.jit(fwd)(params, jnp.asarray(x)))
    calls = []
    w8a8 = tcommon.conv_w8a8

    def rec(xi, kernel, bias, **kw):
        out = w8a8(xi, kernel, bias, **kw)
        calls.append((xi, kernel, bias, out))
        return out
    monkeypatch.setattr(tcommon, "conv_w8a8", rec)
    with torch.inference_mode(), int8_convs(torch.float32):
        got = tm(torch.from_numpy(x), *args)[0].numpy()
    with torch.inference_mode():
        fp32 = tm(torch.from_numpy(x), *args)[0].numpy()
    assert len(calls) >= 5
    for xi, kernel, bias, out in calls:
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            jqconv.conv_w8a8(jnp.asarray(xi.numpy()),
                             jnp.asarray(kernel.detach().numpy()),
                             jnp.asarray(bias.detach().numpy()))))
    d, q = np.abs(got - want), np.abs(got - fp32)
    assert d.max() <= 1e-3 and d.mean() <= 0.5 * q.mean(), (
        d.max(), d.mean(), q.mean())


# ---------------------------------------------------------------------------
# Restorer(compute='int8')
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["denoising-syn", "denoising-real", "sisr"])
def test_restorer_int8_matches_the_jax_restorer(task):
    """Restorer(compute='int8') against the JAX Restorer(compute='int8') on
    one seeded batch and weights: both run bf16 activations, whose
    roundings differ between the two frameworks' convolutions as in bf16
    (the JAX suite's own int8 bar is a finite, in-range output,
    tests/test_qconv.py:108-121).  Stated bar: max abs 2e-2 and mean abs
    2e-3 of a [0, 1] image, the distance of the two bf16 restorers."""
    _, params, _, sd = _pair(task, seed=7)
    kw = SMALL[task]
    x = _img(8, 2, 20, 24, 3)
    jr = JaxRestorer(task, params=params, sf=2, compute="int8", **kw)
    want = np.asarray(jr.restore_batch(jnp.asarray(x)))
    tr = Restorer(task, state_dict=sd, sf=2, device="cpu", compute="int8",
                  **kw)
    assert tr.model.conv_impl == "torch"
    got = tr.restore_batch(x).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.max() <= 2e-2 and d.mean() <= 2e-3, (d.max(), d.mean())
    with pytest.raises(ValueError, match="conv_impl='torch'"):
        Restorer(task, state_dict=sd, sf=2, device="cpu", compute="int8",
                 conv_impl="fused", **kw)


def test_restorer_int8_mesh_takes_the_whole_batchs_scales():
    """Restorer(compute='int8', mesh=[cpu] * 3): three chunks in lockstep
    share every activation scale, so restore_batch of 7 images equals the
    engine without a mesh bit for bit (per-image float convolutions), and
    the JAX Restorer on three devices within the bar above; chunk-local
    scales would differ.  restore_image_sharded runs the strips in fp32,
    as the JAX engine's does: within 1e-5 of the JAX int8 Restorer's
    sharded restore on three devices, and the fp32 engine's bits."""
    task = "denoising-syn"
    _, params, _, sd = _pair(task, seed=9)
    kw = SMALL[task]
    plain = Restorer(task, state_dict=sd, device="cpu", compute="int8", **kw)
    meshed = Restorer(task, state_dict=sd, device="cpu", compute="int8",
                      mesh=Mesh(["cpu"] * 3), **kw)
    x = _img(10, 7, 16, 20, 3)
    x[6] *= 0.25                 # the last chunk's own ranges are smaller
    with torch.backends.mkldnn.flags(enabled=False):
        want = plain.restore_batch(x).numpy()
        got = meshed.restore_batch(x).numpy()
        np.testing.assert_array_equal(got, want)
        local = np.concatenate([plain.restore_batch(c).numpy() for c in
                                np.array_split(np.concatenate(
                                    [x, x[-1:], x[-1:]]), 3)])[:7]
    assert np.abs(local - want).max() > 1e-3
    jr = JaxRestorer(task, params=params, compute="int8",
                     mesh=jax_make_mesh(jax.devices()[:3]), **kw)
    d = np.abs(np.asarray(jr.restore_batch(jnp.asarray(x))) - got)
    assert d.max() <= 2e-2 and d.mean() <= 2e-3, (d.max(), d.mean())
    tall = _img(11, 160, 20, 3)
    got = meshed.restore_image_sharded(tall, halo=48)
    want = jr.restore_image_sharded(tall, jax_make_mesh(jax.devices()[:3]),
                                    halo=48)
    assert got.shape == tall.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    fp32 = Restorer(task, state_dict=sd, device="cpu", **kw)
    np.testing.assert_array_equal(
        got, fp32.restore_image_sharded(tall, Mesh(["cpu"] * 3), halo=48))


def test_lockstep_aborts_instead_of_waiting():
    """A chunk that fails releases the others: its error is raised.  Chunks
    of ``conv_w8a8`` that all finish share the whole batch's activation
    scales, so each equals its slice of the call on the whole batch (the
    int32 sums are exact and the epilogue is per pixel)."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.standard_normal((3, 5, 6, 8))
                          * rng.uniform(0.1, 3.0, 8)).astype(np.float32))
    x[2] *= 0.25                 # the last chunk's own ranges are smaller
    w = torch.from_numpy((rng.standard_normal((3, 3, 8, 4))
                          * 0.1).astype(np.float32))

    def chunk(i):
        return lambda: qconv.conv_w8a8(x[i:i + 1], w)

    def bad():
        raise KeyError("chunk 1")

    with pytest.raises(KeyError, match="chunk 1"):
        qconv.run_lockstep([chunk(0), bad, chunk(2)])
    whole = qconv.conv_w8a8(x, w)
    out = qconv.run_lockstep([chunk(i) for i in range(3)])
    for i in range(3):
        assert torch.equal(out[i], whole[i:i + 1])
    assert not torch.equal(chunk(2)(), whole[2:])
