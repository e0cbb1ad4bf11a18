"""The port's per-sample blur (virnet_tpu_torch/ops/blur.py through
ops/degrade.py) and its neighbours (ops/kernels.py, ops/resize.py) against
the JAX package on the CPU in fp32.  The port runs the kernels' plain
versions here; the JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_blur.py does, and the matmul formulation.  Inputs come
from ``np.random.default_rng(seed)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.ops import degrade as jdeg
from virnet_tpu.ops import kernels as jker
from virnet_tpu.ops import pallas_blur
from virnet_tpu.ops import resize as jres
from virnet_tpu_torch.ops import blur, degrade, kernels, resize
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("pad_mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("correlate", [True, False])
@pytest.mark.parametrize("shape,k", [((2, 16, 18, 3), 5), ((1, 12, 12, 1), 3),
                                     ((2, 9, 11, 2), 7)])
def test_blur_per_sample_matches_jax(shape, k, correlate, pad_mode):
    """Forward against the Pallas op (interpret mode) and the matmul path,
    atol 1e-5: the same k*k products summed in another order."""
    x, kern = _rand(0, *shape), _rand(1, shape[0], k, k)
    got = degrade.blur_per_sample(_t(x), _t(kern), correlate=correlate,
                                  pad_mode=pad_mode).numpy()
    want = jdeg.blur_per_sample(jnp.asarray(x), jnp.asarray(kern),
                                correlate=correlate, pad_mode=pad_mode,
                                impl="matmul")
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    kj = jnp.asarray(kern if correlate else kern[:, ::-1, ::-1])
    want_pl = pallas_blur.blur_per_sample_pallas(jnp.asarray(x), kj,
                                                 pad_mode, True)
    np.testing.assert_allclose(got, np.asarray(want_pl), atol=1e-5)


@pytest.mark.parametrize("pad_mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("correlate", [True, False])
def test_blur_gradients_match_jax(correlate, pad_mode):
    """Gradients wrt x and kernels through _ValidBlur (plain dX and dW) and
    the pad's autograd against jax.grad of the matmul path, atol 1e-4 (the
    bar of tests/test_pallas_blur.py)."""
    x, kern, g = _rand(2, 2, 10, 12, 2), _rand(3, 2, 5, 5), _rand(4, 2, 10,
                                                                   12, 2)
    xt, kt = _t(x, True), _t(kern, True)
    out = degrade.blur_per_sample(xt, kt, correlate=correlate,
                                  pad_mode=pad_mode)
    dx, dk = torch.autograd.grad((out * _t(g)).sum(), (xt, kt))

    def loss(x, k):
        return jnp.sum(jdeg.blur_per_sample(
            x, k, correlate=correlate, pad_mode=pad_mode,
            impl="matmul") * g)

    dx_j, dk_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(kern))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-4)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), atol=1e-4)


def test_blur_gradient_matches_pallas_vjp():
    """The same gradients against the Pallas custom VJP in interpret mode."""
    x, kern, g = _rand(5, 2, 10, 10, 2), _rand(6, 2, 3, 3), _rand(7, 2, 10,
                                                                   10, 2)
    xt, kt = _t(x, True), _t(kern, True)
    out = degrade.blur_per_sample(xt, kt)
    dx, dk = torch.autograd.grad((out * _t(g)).sum(), (xt, kt))
    dx_j, dk_j = jax.grad(
        lambda x, k: jnp.sum(pallas_blur.blur_per_sample_pallas(
            x, k, "reflect", True) * g), argnums=(0, 1))(
                jnp.asarray(x), jnp.asarray(kern))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-4)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), atol=1e-4)


@pytest.mark.parametrize("n,c,h,w,k", [(2, 3, 12, 14, 5), (1, 2, 3, 4, 5),
                                       (2, 1, 8, 3, 7)])
def test_plain_dx_dw_match_pallas_kernels(n, c, h, w, k):
    """blur_dx_plain / blur_dw_plain / blur_valid_plain against the MXU
    kernels in interpret mode (NCHW there, NHWC here), atol 2e-5, at the
    JAX test's shape and at shapes with H or W smaller than k."""
    rng = np.random.default_rng(8)
    g = rng.random((n, c, h, w)).astype(np.float32)
    kern = rng.random((n, k, k)).astype(np.float32)
    xp = rng.random((n, c, h + k - 1, w + k - 1)).astype(np.float32)
    nhwc = lambda a: _t(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))  # noqa: E731
    nchw = lambda t: t.numpy().transpose(0, 3, 1, 2)  # noqa: E731
    want = pallas_blur._blur_mxu_dx(jnp.asarray(g), jnp.asarray(kern),
                                    interpret=True)
    got = blur.blur_dx_plain(nhwc(g), _t(kern))
    assert got.shape == (n, h + k - 1, w + k - 1, c)
    np.testing.assert_allclose(nchw(got), np.asarray(want), atol=2e-5)
    want = pallas_blur._blur_mxu_dw(jnp.asarray(xp), jnp.asarray(g),
                                    interpret=True)
    got = blur.blur_dw_plain(nhwc(xp), nhwc(g))
    # a sum of c*h*w products of values in [0, 1): 1e-5 of the largest tap
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 * float(np.abs(want).max()))
    want = pallas_blur._blur_mxu_valid(jnp.asarray(xp), jnp.asarray(kern),
                                       interpret=True)
    got = blur.blur_valid_plain(nhwc(xp), _t(kern))
    np.testing.assert_allclose(nchw(got), np.asarray(want), atol=2e-5)


def test_plain_backward_is_the_adjoint_of_the_forward():
    """<blur_valid(xp, k), g> is linear in xp and in k, so it equals
    <xp, blur_dx(g, k)> and <k, blur_dw(xp, g)> (float64, rtol 1e-12)."""
    rng = np.random.default_rng(9)
    xp, kern, g = (torch.tensor(rng.random(s)) for s in
                   ((2, 9, 8, 3), (2, 5, 5), (2, 5, 4, 3)))
    lhs = (blur.blur_valid_plain(xp, kern) * g).sum()
    torch.testing.assert_close((xp * blur.blur_dx_plain(g, kern)).sum(), lhs,
                               rtol=1e-12, atol=0)
    torch.testing.assert_close((kern * blur.blur_dw_plain(xp, g)).sum(), lhs,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
def test_pad_hw_matches_numpy(mode):
    x = _rand(10, 2, 5, 6, 3)
    got = blur.pad_hw(_t(x), 3, mode)
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), np.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode=mode))
    with pytest.raises(ValueError):
        blur.pad_hw(_t(x), 6, mode)
    with pytest.raises(ValueError):
        blur.pad_hw(_t(x), 1, "edge")


def test_blur_wrappers_reject_bad_shapes():
    xp, kern = _t(_rand(11, 2, 9, 9, 3)), _t(_rand(12, 2, 5, 5))
    with pytest.raises(ValueError):
        blur.blur_valid(xp, kern[:1])
    with pytest.raises(ValueError):
        blur.blur_valid(xp[:, :4], kern)
    with pytest.raises(ValueError):
        blur._check_k(4)
    with pytest.raises(ValueError):
        blur._check_k(27)
    with pytest.raises(ValueError):
        blur._check_k(9)       # odd, but no kernel is built for it
    for k in blur.SUPPORTED_K:
        blur._check_k(k)


@pytest.mark.parametrize("sf,shift", [(2, False), (3, True), (4, False),
                                      (4, True)])
def test_sigma2kernel_matches_jax(sf, shift):
    """Kernels atol 1e-7 (softmax outputs below 1, float64 here against
    float32 there) and the gradient wrt the covariance, 1e-4 of its max."""
    rng = np.random.default_rng(13)
    a = rng.normal(size=(4, 2, 2)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) + 0.3 * np.eye(2, dtype=np.float32)
    w = _rand(14, 4, 7, 7)
    ct = _t(cov, True)
    got = kernels.sigma2kernel(ct, 7, sf, shift)
    want = jker.sigma2kernel(jnp.asarray(cov), 7, sf, shift)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-7)
    np.testing.assert_allclose(got.detach().numpy().sum((1, 2)), 1.0,
                               atol=1e-6)
    dc, = torch.autograd.grad((got * _t(w)).sum(), ct)
    dc_j = jax.grad(lambda c: jnp.sum(
        jker.sigma2kernel(c, 7, sf, shift) * w))(jnp.asarray(cov))
    np.testing.assert_allclose(dc.numpy(), np.asarray(dc_j),
                               atol=1e-4 * float(np.abs(dc_j).max()))


def test_kinfo2kernel_matches_jax_and_near_singular_covariance():
    kinfo = np.array([[1.5, 0.7, 0.3], [4.0, 4.0, 0.0], [0.2, 9.0, -0.8]],
                     np.float32)
    got = kernels.kinfo2kernel(_t(kinfo), 21, 4)
    want = jker.kinfo2kernel(jnp.asarray(kinfo), 21, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    # det = 0 exactly: the jitter branch of _inv2x2
    cov = np.array([[[1.0, 1.0], [1.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]],
                    [[2.0, 0.5], [0.5, 1.0]]], np.float32)
    np.testing.assert_allclose(kernels._inv2x2(_t(cov)).numpy(),
                               np.asarray(jker._inv2x2(jnp.asarray(cov))),
                               rtol=1e-6)
    got = kernels.sigma2kernel(_t(cov), 5, 2)
    want = jker.sigma2kernel(jnp.asarray(cov), 5, 2)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def test_numpy_kernel_helpers_match_jax_package():
    for args in ((21, 4, 1.2, 5.0, 0.4, True), (15, 2, 0.8, 0.8, 1.0, False)):
        a, ia = kernels.anisotropic_gaussian_np(*args)
        b, ib = jker.anisotropic_gaussian_np(*args)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)
    k = _rand(15, 9, 9)
    for size in (21, 5):
        np.testing.assert_array_equal(kernels.tidy_kernel(k, size),
                                      jker.tidy_kernel(k, size))
    for ksz, s in ((5, -1.0), (9, 2.0)):
        np.testing.assert_array_equal(kernels.gaussian_filter_kernel(ksz, s),
                                      jker.gaussian_filter_kernel(ksz, s))


@pytest.mark.parametrize("sf", [2, 3, 4])
def test_resize_matches_jax(sf):
    """resize_matrix bit for bit; resize_nhwc and downsample atol 1e-6 at
    x1/2, x1/3, x1/4; resize_np bit for bit."""
    for in_sz in (24, 25):
        out_sz = int(np.ceil(in_sz / sf))
        np.testing.assert_array_equal(
            resize.resize_matrix(in_sz, out_sz, 1.0 / sf),
            jres.resize_matrix(in_sz, out_sz, 1.0 / sf))
    x = _rand(16, 2, 24, 36, 3)
    got = resize.resize_nhwc(_t(x), scale_factors=1.0 / sf)
    want = jres.resize_nhwc(jnp.asarray(x), scale_factors=1.0 / sf)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        degrade.downsample(_t(x), sf, "bicubic").numpy(), np.asarray(want),
        atol=1e-6)
    np.testing.assert_array_equal(
        degrade.downsample(_t(x), sf, "direct").numpy(), x[:, ::sf, ::sf])
    np.testing.assert_array_equal(
        resize.resize_np(x[0], scale_factors=1.0 / sf),
        jres.resize_np(x[0], scale_factors=1.0 / sf))
    up = resize.resize_nhwc(_t(x[:, :6, :6]), out_shape=(9, 12))
    want_up = jres.resize_nhwc(jnp.asarray(x[:, :6, :6]), out_shape=(9, 12))
    np.testing.assert_allclose(up.numpy(), np.asarray(want_up), atol=1e-6)


@pytest.mark.parametrize("sf,k,downsampler", [(2, 5, "bicubic"),
                                              (4, 7, "bicubic"),
                                              (2, 7, "direct")])
def test_degrade_batch_value_and_gradient(sf, k, downsampler):
    """degrade_batch (blur + downsample) against the JAX function: value
    atol 1e-5, gradients wrt the image and the kernels atol 1e-4."""
    x, kern = _rand(17, 2, 32, 32, 3), _rand(18, 2, k, k)
    kern /= kern.sum((1, 2), keepdims=True)
    g = _rand(19, 2, 32 // sf, 32 // sf, 3)
    xt, kt = _t(x, True), _t(kern, True)
    out = degrade.degrade_batch(xt, kt, sf, downsampler)
    want = jdeg.degrade_batch(jnp.asarray(x), jnp.asarray(kern), sf,
                              downsampler)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    dx, dk = torch.autograd.grad((out * _t(g)).sum(), (xt, kt))
    dx_j, dk_j = jax.grad(lambda x, k: jnp.sum(
        jdeg.degrade_batch(x, k, sf, downsampler) * g), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(kern))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), atol=1e-4)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), atol=1e-4)


def test_cotangent_copy_is_counted():
    """A broadcast cotangent (from ``.sum()``) is made contiguous for the
    backward kernels, and the copy is counted."""
    from virnet_tpu_torch.ops import fused_conv as fc

    fc.reset_launches()
    xt = _t(_rand(20, 1, 8, 8, 2), True)
    degrade.blur_per_sample(xt, _t(_rand(21, 1, 3, 3))).sum().backward()
    assert fc.COPIES["blur_cotangent"] == 1
    assert xt.grad.shape == xt.shape
    fc.reset_launches()
    assert fc.COPIES["blur_cotangent"] == 0
    assert all(v == 0 for v in fc.LAUNCHES.values())   # CPU: no launches
