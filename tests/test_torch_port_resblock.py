"""K11 (ops/resblock.py) on the CPU: the split of the output channels, the
weights' layout, the plain version of both modes against today's
AttResBlock arithmetic in fp32 and bf16 at RNet's widths, and the route
that takes an unconditioned block of a kernel-built bf16 model on the card
to K11 and leaves every other block, compute and build on the library
route.  The card's own checks are in tests/test_torch_port_card.py."""

import contextlib

import numpy as np
import pytest
import torch

from virnet_tpu_torch.models import attresunet, build_model
from virnet_tpu_torch.models.attresunet import AttResBlock, AttResUNet
from virnet_tpu_torch.models.common import hwio, to_nchw, to_nhwc
from virnet_tpu_torch.ops import fused_conv as fc
from virnet_tpu_torch.ops import resblock
from virnet_tpu_torch.precision import im2col_convs, int8_convs

WIDTHS = (96, 160, 192, 224, 288)   # RNet's body widths, every preset


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, dtype):
    """fp32: the same function with other rounding points only in float32
    (atol 2e-5 of the scale).  bf16: today's route rounds after the conv,
    the bias, each LeakyReLU and the residual, K11 once, so they differ
    by a few bf16 ulps; 4 ulps (2^-6) of the tensor's scale, where a wrong
    tap or a lost pass moves outputs by a large part of it."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    scale = max(1.0, float(want.abs().max()))
    tol = (2e-5 if dtype == torch.float32 else 2 ** -6) * scale
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def _block(nf, dtype, seed=0):
    torch.manual_seed(seed)
    return AttResBlock(nf).to(dtype).eval()


def _x(shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def test_plan_cuts_rnet_widths_without_padding():
    """One split up to 112 channels, else splits of one width the kernel
    was built for that add up to the width exactly at every RNet width;
    widths that are no multiple of 16 are not taken."""
    want = {96: (96, 1), 160: (80, 2), 192: (96, 2), 224: (112, 2),
            288: (96, 3), 64: (64, 1), 112: (112, 1)}
    for c, p in want.items():
        assert resblock.plan(c, c) == p
    for c in (16, 48, 128, 256, 320, 1024, 2048):
        n, splits = resblock.plan(c, c)
        assert n in resblock.WIDTHS and (splits - 1) * n < c <= splits * n
    for ci, co in ((24, 24), (96, 8), (0, 96), (8, 8), (-16, 96),
                   (96, 100)):
        assert resblock.plan(ci, co) is None


@pytest.mark.parametrize("ci,co", [(96, 96), (160, 160), (288, 288),
                                   (48, 96), (224, 208)])
def test_kernel_weights_lay_out_each_split_and_chunk(ci, co):
    """kernel_weights puts w[t // 3, t % 3, 16c + 8h + e, sN + n] at [s, c,
    t, h, n, e], zeros past Co, and hwio_weights takes it back bit for
    bit."""
    w = _x((3, 3, ci, co), torch.float32)
    wk = resblock.kernel_weights(w)
    n, splits = resblock.plan(ci, co)
    assert wk.shape == (splits, ci // 16, 9, 2, n, 8) and wk.is_contiguous()
    assert torch.equal(resblock.hwio_weights(wk, co), w)
    rng = np.random.default_rng(ci + co)
    for _ in range(20):
        s, c, t, h, j, e = (int(rng.integers(d)) for d in wk.shape)
        o = s * n + j
        want = w[t // 3, t % 3, 16 * c + 8 * h + e, o] if o < co else 0.0
        assert wk[s, c, t, h, j, e] == want
    with pytest.raises(ValueError, match="3x3"):
        resblock.kernel_weights(w[:1])
    with pytest.raises(ValueError, match="multiples of 16"):
        resblock.kernel_weights(w[..., :co - 4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("nf", WIDTHS)
def test_plain_modes_match_todays_block(nf, dtype):
    """'first' then 'second' (the plain versions) give today's
    AttResBlock output, and the wrapper on CPU tensors with the laid-out
    weights gives the plain versions' bits, launching nothing."""
    blk = _block(nf, dtype)
    x = _x((2, 5, 7, nf), dtype)
    with torch.inference_mode():
        today = to_nhwc(blk(to_nchw(x), None))
        w1, w2 = hwio(blk.conv1.weight), hwio(blk.conv2.weight)
        f = resblock.resblock_conv_plain(x, w1, blk.conv1.bias, "first")
        out = resblock.resblock_conv_plain(f, w2, blk.conv2.bias, "second",
                                           residual=x)
        assert f.dtype == out.dtype == dtype
        _close(out, today, dtype)
        fc.reset_launches()
        f_w = resblock.resblock_conv(x, resblock.kernel_weights(w1),
                                     blk.conv1.bias, "first")
        out_w = resblock.resblock_conv(f_w, resblock.kernel_weights(w2),
                                       blk.conv2.bias, "second", residual=x)
    assert torch.equal(f_w, f) and torch.equal(out_w, out)
    assert fc.LAUNCHES["resblock_conv"] == 0


def test_plain_first_applies_lrelu_before_and_after():
    """'first' is lrelu(conv(lrelu(x)) + b), with the input's LeakyReLU
    rounded to x's dtype; 'second' adds the residual after the bias; an
    unknown mode is refused."""
    x = _x((1, 4, 4, 16), torch.bfloat16)
    w = _x((3, 3, 16, 16), torch.bfloat16, seed=2) * 0.1
    b = _x((16,), torch.bfloat16, seed=3)
    xin = torch.nn.functional.leaky_relu(x, 0.2)
    y = fc.conv3x3_f32(xin, w, b)
    want = torch.nn.functional.leaky_relu(y, 0.2).to(torch.bfloat16)
    assert torch.equal(resblock.resblock_conv_plain(x, w, b, "first"), want)
    r = _x((1, 4, 4, 16), torch.bfloat16, seed=4)
    want2 = (fc.conv3x3_f32(x, w, b) + r.float()).to(torch.bfloat16)
    assert torch.equal(resblock.resblock_conv_plain(x, w, b, "second",
                                                    residual=r), want2)
    with pytest.raises(ValueError, match="mode"):
        resblock.resblock_conv_plain(x, w, b, "third")


@contextlib.contextmanager
def _routed(monkeypatch):
    """The card's device gate opened for CPU tensors, and every K11 call
    recorded (the wrapper then runs its plain version)."""
    calls = []
    real = resblock.resblock_conv

    def record(x, wk, b, mode, residual=None):
        calls.append((tuple(x.shape), mode))
        return real(x, wk, b, mode, residual)

    monkeypatch.setattr(attresunet, "_on_card", lambda x: True)
    monkeypatch.setattr(resblock, "resblock_conv", record)
    fc.reset_launches()
    yield calls
    assert fc.LAUNCHES["resblock_conv"] == 0


def _unet(dtype, **kw):
    cfg = dict(in_chn=3, extra_chn=1, out_chn=3, n_feat=(16, 32),
               n_resblocks=1, extra_mode="input")
    cfg.update(kw)
    torch.manual_seed(5)
    return AttResUNet(**cfg).to(dtype).eval()


def _unet_inputs(dtype, extra_chn=1):
    x = torch.from_numpy(np.random.default_rng(6).random(
        (2, 8, 8, 3), dtype=np.float32))
    e = torch.from_numpy(np.random.default_rng(7).random(
        (2, 8, 8, extra_chn), dtype=np.float32)).to(dtype)
    return x, e


def test_route_takes_k11_for_unconditioned_bf16_kernel_blocks(monkeypatch):
    """A kernel-built bf16 RNet on the card: every body block (two down,
    one up) runs as K11 'first' then 'second' on NHWC views at its width,
    and the output agrees with today's route."""
    net = _unet(torch.bfloat16)
    x, e = _unet_inputs(torch.bfloat16)
    with torch.inference_mode():
        want = _unet(torch.bfloat16, tail_impl="torch")(x, e)
        with _routed(monkeypatch) as calls:
            got = net(x, e)
    assert calls == [((2, 8, 8, 16), "first"), ((2, 8, 8, 16), "second"),
                     ((2, 4, 4, 32), "first"), ((2, 4, 4, 32), "second"),
                     ((2, 8, 8, 16), "first"), ((2, 8, 8, 16), "second")]
    _close(got, want, torch.bfloat16)


def test_route_takes_k11_on_sisr_up_path_only(monkeypatch):
    """SISR's RNet conditions its down path (SFT): those blocks keep
    today's route, the unconditioned up-path blocks take K11."""
    net = _unet(torch.bfloat16, extra_mode="both", extra_chn=4)
    x, e = _unet_inputs(torch.bfloat16, extra_chn=4)
    with torch.inference_mode(), _routed(monkeypatch) as calls:
        net(x, e[:, :1, :1])
    assert calls == [((2, 8, 8, 16), "first"), ((2, 8, 8, 16), "second")]


@pytest.mark.parametrize("case", ["fp32", "int8", "autograd", "conv_torch",
                                  "conditioned", "widths", "im2col",
                                  "cpu_gate"])
def test_route_bypasses_k11(case, monkeypatch):
    """fp32, the int8 mode, autograd recording, a conv_impl='torch' build,
    a conditioned block, widths K11 does not take, the im2col route, and a
    tensor off the card all keep today's route: no K11 call, no launch."""
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    nf = 24 if case == "widths" else 16
    blk = _block(nf, dtype)
    blk.kernels = case != "conv_torch"
    x = to_nchw(_x((1, 8, 8, nf), dtype))
    extra = None
    if case == "conditioned":
        blk = AttResBlock(nf, extra_chn=2).to(dtype).eval()
        blk.kernels = True
        extra = to_nchw(_x((1, 1, 1, 2), dtype))
    ctx = {"int8": int8_convs(torch.bfloat16),
           "im2col": im2col_convs()}.get(case, contextlib.nullcontext())
    grad = torch.enable_grad() if case == "autograd" else \
        torch.inference_mode()
    with grad, ctx, _routed(monkeypatch) as calls:
        if case == "cpu_gate":
            monkeypatch.setattr(attresunet, "_on_card", lambda t: t.is_cuda)
        assert not blk.takes_kernel(x, extra)
        out = blk(x, extra)
    assert calls == [] and out.shape == x.shape
    if case == "autograd":
        out.float().sum().backward()
        assert blk.conv1.weight.grad is not None


def test_builds_carry_the_kernel_choice():
    """Every AttResBlock of a kernel-built model carries the choice (the
    same as RNet's tail_impl); the trainers' conv_impl='torch' models and
    int8's do not."""
    for task in ("denoising-syn", "denoising-real", "sisr"):
        fused = build_model(task)
        blocks = [m for m in fused.modules() if isinstance(m, AttResBlock)]
        assert blocks and all(b.kernels for b in blocks)
        torch_built = build_model(task, conv_impl="torch")
        assert not any(b.kernels for b in torch_built.modules()
                       if isinstance(b, AttResBlock))
    syn = build_model("denoising-syn")
    widths = [b.conv1.weight.shape[0] for b in syn.modules()
              if isinstance(b, AttResBlock)]
    assert sorted(widths) == [96] * 6 + [192] * 6 + [288] * 3
    assert all(resblock.plan(c, c) is not None for c in widths)
