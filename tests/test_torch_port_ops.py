"""The port's kernel modules (virnet_tpu_torch/ops/fused_conv.py) against
the JAX Pallas kernels they replace (virnet_tpu/ops/pallas_conv.py, run in
interpret mode on the CPU).  On the CPU each wrapper runs its plain
PyTorch version, so these tests hold that version — the kernel's exact
decomposition — to the reference.  The CUDA kernels themselves are held
against the plain versions on the card (tests/test_torch_port_card.py and
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virnet_tpu.ops import pallas_conv as pc
from virnet_tpu_torch.ops import fused_conv as fc
from test_torch_port_shared import _one_thread  # noqa: F401 (autouse)

LMIN, LMAX = float(np.log(1e-10)), float(np.log(1e2))
TOL = 5e-6   # fp32 bar of tests/test_fused_head.py:58


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _snet(rng, L, co, cf=None, nf=64):
    """HWIO SNet (+ head) weights at DnCNN-like scales."""
    p = dict(w1=_rand(rng, (3, 3, 3, nf), 0.2), b1=_rand(rng, (nf,), 0.05),
             wms=[_rand(rng, (3, 3, nf, nf), 0.04) for _ in range(L)],
             bms=[_rand(rng, (nf,), 0.05) for _ in range(L)],
             wl=_rand(rng, (3, 3, nf, co), 0.04), bl=_rand(rng, (co,), 0.05))
    if cf is not None:
        p.update(wh=_rand(rng, (3, 3, 3 + co, cf), 0.1),
                 bh=_rand(rng, (cf,), 0.05))
    return p


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _args(p, keys, conv):
    return [[conv(w) for w in p[k]] if isinstance(p[k], list) else conv(p[k])
            for k in keys]


@pytest.mark.parametrize("slope", [None, 0.25])
def test_conv3x3_mid_matches_pallas(slope):
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 10, 16, 64))
    w, b = _rand(rng, (3, 3, 64, 64), 0.05), _rand(rng, (64,), 0.1)
    want = pc.unpair(pc.conv3x3_mid_pair(pc.pair(_j(x)), _j(w), _j(b),
                                         slope=slope, interpret=True))
    got = fc.conv3x3_mid(_t(x), _t(w), _t(b), slope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_conv3x3_mid_stack_matches_pallas():
    rng = np.random.default_rng(1)
    x = _rand(rng, (1, 16, 16, 64))
    ws = [_rand(rng, (3, 3, 64, 64), 0.05) for _ in range(3)]
    bs = [_rand(rng, (64,), 0.1) for _ in range(3)]
    want = pc.unpair(pc.conv3x3_mid_stack_pair(
        pc.pair(_j(x)), [_j(w) for w in ws], [_j(b) for b in bs],
        slope=0.25, interpret=True))
    got = fc.conv3x3_mid_stack(_t(x), [_t(w) for w in ws],
                               [_t(b) for b in bs], 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("shape,L,co", [
    ((2, 16, 16, 3), 3, 1),     # denoising-syn depth
    ((1, 16, 15, 3), 3, 1),     # odd W: pad-and-remask on the TPU side
    ((1, 16, 20, 3), 6, 3),     # denoising-real depth
])
def test_dncnn_fused_matches_pallas(shape, L, co):
    rng = np.random.default_rng(2)
    x = rng.random(shape, dtype=np.float32)
    p = _snet(rng, L, co)
    keys = ("w1", "b1", "wms", "bms", "wl", "bl")
    want = pc.dncnn_pair_fused(_j(x), *_args(p, keys, _j), slope=0.25,
                               interpret=True)
    got = fc.dncnn_fused(_t(x), *_args(p, keys, _t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("mode", ["halo", "carry"])
@pytest.mark.parametrize("shape,L,co", [((2, 16, 16, 3), 3, 1),
                                        ((1, 16, 24, 3), 6, 3)])
def test_dncnn_head_fused_matches_pallas(mode, shape, L, co):
    rng = np.random.default_rng(3)
    x = rng.random(shape, dtype=np.float32)
    p = _snet(rng, L, co, cf=16)
    keys = ("w1", "b1", "wms", "bms", "wl", "bl", "wh", "bh")
    h_want, s_want = pc.dncnn_head_fused(
        _j(x), *_args(p, keys, _j), slope=0.25, lmin=LMIN, lmax=LMAX,
        interpret=True, mode=mode)
    h_got, s_got = fc.dncnn_head_fused(_t(x), *_args(p, keys, _t),
                                       lmin=LMIN, lmax=LMAX)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), atol=TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), atol=TOL)


def test_tail_residual_matches_pallas():
    rng = np.random.default_rng(4)
    feats = _rand(rng, (2, 16, 16, 32))
    x_in = rng.random((2, 16, 16, 3), dtype=np.float32)
    w, b = _rand(rng, (3, 3, 32, 3), 0.05), _rand(rng, (3,), 0.1)
    want = pc.unpair(pc.conv3x3_tail_residual(
        pc.pair(_j(feats)), pc.pair(_j(x_in)), _j(w), _j(b),
        interpret=True))
    got = fc.conv3x3_tail_residual(_t(feats), _t(x_in), _t(w), _t(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_tail_residual_pad_case_matches_reference():
    """Features at the padded size, x_in at the image size: the reference
    conv + slice + residual of virnet_tpu/models/attresunet.py:204-215,228."""
    rng = np.random.default_rng(5)
    feats = _rand(rng, (1, 20, 24, 32))
    x_in = rng.random((1, 17, 22, 3), dtype=np.float32)
    w, b = _rand(rng, (3, 3, 32, 3), 0.05), _rand(rng, (3,), 0.1)
    out = jax.lax.conv_general_dilated(
        _j(feats), _j(w), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    want = (out + _j(b))[:, :17, :22, :] + _j(x_in)
    got = fc.conv3x3_tail_residual(_t(feats), _t(x_in), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_tail_residual_bf16_matches_pallas():
    """bf16 features, f32 residual (the bf16 serving path): both sides
    round the f32-accumulated conv once to bf16, so they differ by at most
    one bf16 ulp of the conv output where the summation order flips a
    rounding (the bound of tests/test_fused_tail.py:148-153)."""
    rng = np.random.default_rng(6)
    feats = _rand(rng, (1, 8, 16, 8))
    x_in = _rand(rng, (1, 8, 16, 3))
    w, b = _rand(rng, (3, 3, 8, 3)), _rand(rng, (3,))
    fb, wb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (feats, w, b))
    want = pc.unpair(pc.conv3x3_tail_residual(
        pc.pair(fb), pc.pair(_j(x_in)), wb, bb, interpret=True))
    tb = [_t(a.astype(jnp.float32)).bfloat16()
          for a in (fb, wb, bb)]
    got = fc.conv3x3_tail_residual(tb[0], _t(x_in), tb[1], tb[2])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.09)


def test_cpu_calls_count_no_launches():
    fc.reset_launches()
    rng = np.random.default_rng(7)
    x = _t(_rand(rng, (1, 8, 8, 64)))
    fc.conv3x3_mid(x, _t(_rand(rng, (3, 3, 64, 64))), _t(_rand(rng, (64,))))
    assert all(v == 0 for v in fc.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA gets no silent
    fallback."""
    x = torch.empty((1, 8, 8, 64), device="meta")
    w = torch.empty((3, 3, 64, 64), device="meta")
    b = torch.empty((64,), device="meta")
    with pytest.raises(ValueError):
        fc.conv3x3_mid(x, w, b)
    with pytest.raises(ValueError):
        fc.conv3x3_mid(x, torch.zeros((3, 3, 64, 64)), torch.zeros(64))


@pytest.mark.parametrize("dtype,offset,ok", [
    (torch.float32, 0, True), (torch.float32, 1, False),
    (torch.bfloat16, 8, True), (torch.bfloat16, 4, False),
], ids=["f32-aligned", "f32-offset", "bf16-aligned", "bf16-offset"])
def test_alignment_check_of_the_16_byte_kernels(dtype, offset, ok):
    """K1 and K4 copy and store 16 bytes at a time; their wrappers hold
    every such pointer to a 16-byte boundary before a launch (the check
    itself looks only at the address, so it runs here on CPU tensors)."""
    buf = torch.zeros(64 + offset, dtype=dtype)
    view = buf[offset:offset + 64]
    if ok:
        fc._aligned(x=view)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fc._aligned(x=view)


def _bf16_close(got, want, log=False):
    """Both sides round every conv once to bf16 with f32 sums taken in
    other orders, so a 1-ulp flip at one level can carry through the later
    ones: 4 bf16 ulps (2^-6) of the tensor's scale (of log sigma for
    sigma), the card's bar, where a wrong tap moves outputs by a large part
    of their scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if log:
        got, want = np.log(got), np.log(want)
    tol = 2 ** -6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("shape,L,co", [((2, 16, 16, 3), 3, 1),
                                        ((1, 16, 24, 3), 6, 3)],
                         ids=["syn", "real"])
def test_dncnn_head_fused_bf16_matches_pallas(shape, L, co):
    """The bf16 plain version, the yardstick the bf16 kernel is held to on
    the card, against the Pallas kernel in bf16 (interpret mode)."""
    rng = np.random.default_rng(15)
    x = rng.random(shape, dtype=np.float32)
    p = _snet(rng, L, co, cf=16)
    keys = ("w1", "b1", "wms", "bms", "wl", "bl", "wh", "bh")

    def jb(a):
        return jnp.asarray(a, jnp.bfloat16)

    h_want, s_want = pc.dncnn_head_fused(
        jb(x), *_args(p, keys, jb), slope=0.25, lmin=LMIN, lmax=LMAX,
        interpret=True)
    assert h_want.dtype == jnp.bfloat16

    def tb(a):
        return _t(a).bfloat16()

    h_got, s_got = fc.dncnn_head_fused(tb(x), *_args(p, keys, tb),
                                       lmin=LMIN, lmax=LMAX)
    assert h_got.dtype == s_got.dtype == torch.bfloat16
    _bf16_close(s_got.float().numpy(), np.asarray(s_want, np.float32),
                log=True)
    _bf16_close(h_got.float().numpy(), np.asarray(h_want, np.float32))


def test_every_kernel_library_is_built():
    """Each library a C entry is looked up in is one that the build
    compiles, from its own source under csrc/."""
    from virnet_tpu_torch.ops import _build

    libs = {lib for lib, _ in fc._SIGNATURES.values()}
    assert libs <= set(_build.SOURCES)
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file(), name


def _c_entries(name):
    """The names of the extern "C" functions that csrc/<name>.cu defines."""
    import re

    from virnet_tpu_torch.ops import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    return set(re.findall(r'extern "C"\s+[\w ]+?\b(vt_\w+)\s*\(', src))


@pytest.mark.parametrize("symbol", sorted(fc._SIGNATURES))
def test_every_signature_is_an_entry_of_its_source(symbol):
    """Each C entry the wrappers bind is an extern "C" function of the
    source its library is built from, so that no binding outlives the
    code it names."""
    lib, _ = fc._SIGNATURES[symbol]
    assert symbol in _c_entries(lib)


def test_dncnn_fused_source_holds_the_probe_only():
    """The probe K8 left PR 1's csrc/dncnn_fused.cu for K3's own device
    code: no source exports the old probe's entries nor those of the fused
    bf16 K3 that csrc/dncnn_head.cu held before its level chain, K8's
    entries are K3's (the chain of csrc/dncnn_head.cu in bf16, that of
    csrc/snet_levels.cu in fp32), and the build lists no source that
    exports no entry."""
    from virnet_tpu_torch.ops import _build

    assert "dncnn_fused" not in _build.SOURCES
    assert not (_build.CSRC / "dncnn_fused.cu").exists()
    entries = {name: _c_entries(name) for name in _build.SOURCES}
    old = {"vt_dncnn_slab_grid", "vt_dncnn_slab_scratch_elems",
           "vt_dncnn_head_slabzero", "vt_dncnn_head_grid",
           "vt_dncnn_head_scratch_elems", "vt_dncnn_head"}
    assert not old & set().union(*entries.values())
    assert not old & set(fc._SIGNATURES)
    assert entries["dncnn_head"] == {"vt_dncnn_head_conv1",
                                     "vt_dncnn_head_mid",
                                     "vt_dncnn_head_last"}
    assert entries["snet_levels"] == {"vt_snet_conv1", "vt_snet_last"}
    assert all(entries.values()), entries
    assert {fc._SIGNATURES[s][0] for s in ("vt_snet_conv1",
                                           "vt_snet_last")} == {
        "snet_levels"}


def _kernels(name):
    """The names of the __global__ functions that csrc/<name>.cu defines."""
    import re

    from virnet_tpu_torch.ops import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    return re.findall(r"__global__\s+void\s+"
                      r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", src)


# name fragments that the benchmark's K2 chain and K11 counts read
OTHER_ROUTES = ("snet_conv1", "snet_last", "conv3x3_mid_", "resblock_conv_")


@pytest.mark.parametrize("kernel", ["dncnn_head_conv1_kernel",
                                    "dncnn_head_mid_kernel",
                                    "dncnn_head_last_kernel"])
def test_k3_route_launches_only_kernels_named_for_k3(kernel):
    """K3's and K8's bf16 route launches only the kernels of
    csrc/dncnn_head.cu, each named dncnn_head_* and named nothing that the
    K2 chain's or K11's counts read, so that a trace credits the whole
    route to K3 (portbench/counts/k3.py) and none of it to another
    kernel; snet_levels.cu's kernels carry no K3 name."""
    from portbench.counts import k3, k11, snet_chain

    assert kernel in _kernels("dncnn_head")
    assert set(_kernels("dncnn_head")) == {
        "dncnn_head_conv1_kernel", "dncnn_head_mid_kernel",
        "dncnn_head_last_kernel"}
    assert any(k in kernel for k in k3.KERNELS)
    assert not any(k in kernel for k in OTHER_ROUTES)
    assert not any(k in kernel for k in snet_chain.KERNELS + k11.KERNELS)
    for other in _kernels("snet_levels") + _kernels("conv3x3_mid"):
        assert not any(k in other for k in k3.KERNELS), other


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_dncnn_head_mid_runs_its_plain_version_on_the_cpu(dtype):
    """K3's wgmma mid level on CPU tensors is its plain version, K1's
    function at the SNet's slope, bit for bit, and launches nothing; under
    autograd it raises, as every kernel wrapper does."""
    rng = np.random.default_rng(27)
    x = _t(_rand(rng, (2, 9, 13, 64))).to(dtype)
    w = _t(_rand(rng, (3, 3, 64, 64), 0.04)).to(dtype)
    b = _t(_rand(rng, (64,), 0.05)).to(dtype)
    fc.reset_launches()
    got = fc.dncnn_head_mid(x, w, b, 0.25)
    assert not any(fc.LAUNCHES.values())
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, fc.conv3x3_mid(x, w, b, 0.25), atol=0,
                               rtol=0)
    with pytest.raises(RuntimeError, match="forward-only"):
        fc.dncnn_head_mid(x, w.clone().requires_grad_(), b)
