"""Plain reference of the two VIRNet models the benchmark serves and trains.

Written from the published architecture (the reference repository's
networks/VIRNet.py, AttResUNet.py, DnCNN.py and KNet.py, as the released
``.pth`` files name their tensors) in plain PyTorch: NCHW float32,
``F.conv2d`` for every convolution, autograd for the backward, no kernel,
cache or batching trick.  It imports nothing of the program under test.

``params`` is a flat dict {reference key: tensor}; ``arch`` the
configuration's ``arch`` object.  ``quant``, where given, is applied to the
input and the weight of every convolution (the lower-precision control).
exp, sigmoid and tanh of the variance heads run in float64.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_MAX = math.log(1e2)
LOG_MIN_SIGMA = math.log(1e-10)
LOG_MIN_KERNEL = math.log(1e-4)


def load_state(path) -> dict:
    """A released ``.pth`` (bare state dict or the trainer's wrapper) as
    float32 tensors on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k.removeprefix("module."): v.float() for k, v in sd.items()}


# --------------------------------------------------------------- parameters

def _conv_spec(out: list, name, co, ci, k, bias=True, init="uniform",
               gain=1.0):
    fan_in = ci * k * k
    bound = (gain * math.sqrt(3.0 / fan_in) if init == "orthogonal"
             else 1.0 / math.sqrt(fan_in))
    out.append((f"{name}.weight", (co, ci, k, k), bound))
    if bias:
        out.append((f"{name}.bias", (co,),
                    0.0 if init == "orthogonal" else bound))


def param_specs(arch: dict) -> list:
    """[(key, shape, bound)], one entry for every tensor of the model
    ``arch`` describes, under the released files' keys.  ``bound`` is the
    half-width of a uniform draw with the variance of the trainer's
    initialisation: torch's default U(+-1/sqrt(fan_in)), and for SNet's
    orthogonal init with the leaky-relu gain the same variance,
    gain^2 / fan_in, with zero biases."""
    specs: list = []
    sr = arch["cls"] == "VIRNetSR"
    gain = math.sqrt(2.0 / (1.0 + 0.25 ** 2))
    _conv_spec(specs, "SNet.conv1", 64, arch["im_chn"], 3, init="orthogonal",
               gain=gain)
    for i in range(arch["dep_S"] - 2):
        _conv_spec(specs, f"SNet.mid_layer.{2 * i}", 64, 64, 3,
                   init="orthogonal", gain=gain)
    _conv_spec(specs, "SNet.conv_last", arch["sigma_chn"], 64, 3,
               init="orthogonal", gain=gain)
    extra = arch["sigma_chn"]
    if sr:
        extra += arch["kernel_chn"]
        specs.append(("KNet.head.weight", (64, arch["im_chn"], 9, 9),
                      1.0 / math.sqrt(81 * arch["im_chn"])))
        for i in range(arch["dep_K"]):
            b = f"KNet.body.{i}.body"
            _conv_spec(specs, f"{b}.0", 64, 64, 3)
            _conv_spec(specs, f"{b}.2", 64, 64, 3)
            _conv_spec(specs, f"{b}.3.body.0", 4, 64, 1)
            _conv_spec(specs, f"{b}.3.body.2", 64, 4, 1)
        _conv_spec(specs, "KNet.tail.0", arch["kernel_chn"], 64, 3)
    nf, mode = arch["n_feat"], arch["extra_mode"].lower()
    depth = len(nf)
    head_in = arch["im_chn"] + (extra if mode in ("input", "both") else 0)
    _conv_spec(specs, "RNet.head", nf[0], head_in, 3)
    cond = extra if mode in ("down", "both") else 0
    for i in range(depth):
        for j in range(arch["n_resblocks"]):
            blk = f"RNet.down_path.{i}.body.{j}"
            if cond:
                for s in ("sft1", "sft2"):
                    _conv_spec(specs, f"{blk}.{s}.conv1", nf[i] // 8, cond, 1)
                    _conv_spec(specs, f"{blk}.{s}.conv2", nf[i] // 4,
                               nf[i] // 8, 1)
                    _conv_spec(specs, f"{blk}.{s}.mul_conv", nf[i],
                               nf[i] // 4, 1)
                    _conv_spec(specs, f"{blk}.{s}.add_conv", nf[i],
                               nf[i] // 4, 1)
            _conv_spec(specs, f"{blk}.conv1", nf[i], nf[i], 3)
            _conv_spec(specs, f"{blk}.conv2", nf[i], nf[i], 3)
        if i + 1 < depth:
            _conv_spec(specs, f"RNet.down_path.{i}.downsampler", nf[i + 1],
                       nf[i], 3)
    for k, jj in enumerate(reversed(range(depth - 1))):
        up = f"RNet.up_path.{k}"
        bound = 1.0 / math.sqrt(4 * nf[jj + 1])
        specs.append((f"{up}.upsampler.weight", (nf[jj + 1], nf[jj], 2, 2),
                      bound))
        specs.append((f"{up}.upsampler.bias", (nf[jj],), bound))
        for b in range(arch["n_resblocks"]):
            _conv_spec(specs, f"{up}.body.{b}.conv1", nf[jj], nf[jj], 3)
            _conv_spec(specs, f"{up}.body.{b}.conv2", nf[jj], nf[jj], 3)
    _conv_spec(specs, "RNet.tail", arch["im_chn"], nf[0], 3)
    return specs


def seeded_params(arch: dict, seed: int, device) -> dict:
    """Every tensor of the model from ``seed``: one uniform draw on
    ``device`` for all of them, scaled by each tensor's bound."""
    specs = param_specs(arch)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    bounds = torch.tensor([b for _, _, b in specs], device=device)
    flat *= torch.repeat_interleave(
        bounds, torch.tensor(sizes, device=device))
    return {name: t.view(shape) for (name, shape, _), t in
            zip(specs, flat.split(sizes))}


# ------------------------------------------------------------------ layers

def _conv(x, p, name, stride=1, quant=None, bias=True):
    w = p[f"{name}.weight"]
    b = p.get(f"{name}.bias") if bias else None
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, w.shape[-1] // 2)


def _lrelu(x, slope):
    return F.leaky_relu(x, slope)


def reflect_pad_to(x, mod):
    """Reflect-pad NCHW ``x`` at the bottom and right up to multiples of
    ``mod`` (numpy 'reflect', any amount)."""
    h, w = x.shape[-2:]
    hb, wb = -(-h // mod) * mod, -(-w // mod) * mod
    while x.shape[-2] < hb or x.shape[-1] < wb:
        ph = min(hb - x.shape[-2], x.shape[-2] - 1)
        pw = min(wb - x.shape[-1], x.shape[-1] - 1)
        x = F.pad(x, (0, pw, 0, ph), mode="reflect")
    return x


def snet(x, p, arch, quant=None):
    y = _lrelu(_conv(x, p, "SNet.conv1", quant=quant), 0.25)
    for i in range(arch["dep_S"] - 2):
        y = _lrelu(_conv(y, p, f"SNet.mid_layer.{2 * i}", quant=quant), 0.25)
    return _conv(y, p, "SNet.conv_last", quant=quant)


def _att_layer(extra, p, name, quant):
    f = _lrelu(_conv(extra, p, f"{name}.conv1", quant=quant), 0.2)
    f = _lrelu(_conv(f, p, f"{name}.conv2", quant=quant), 0.2)
    mul = _conv(f, p, f"{name}.mul_conv", quant=quant)
    return (torch.sigmoid(mul.double()).to(mul.dtype),
            _conv(f, p, f"{name}.add_conv", quant=quant))


def _att_res_block(x, extra, p, name, quant):
    t = x
    if extra is not None:
        mul, add = _att_layer(extra, p, f"{name}.sft1", quant)
        t = x * mul + add
    f = _conv(_lrelu(t, 0.2), p, f"{name}.conv1", quant=quant)
    if extra is not None:
        mul, add = _att_layer(extra, p, f"{name}.sft2", quant)
        f = f * mul + add
    f = _conv(_lrelu(f, 0.2), p, f"{name}.conv2", quant=quant)
    return x + f


def rnet(x, extra, p, arch, quant=None):
    """AttResUNet on NCHW ``x``; ``extra`` is a full map (N, E, H, W) or
    the per-sample (N, E, 1, 1) conditioning of the SISR model."""
    nf, mode = arch["n_feat"], arch["extra_mode"].lower()
    depth = len(nf)
    h, w = x.shape[-2:]
    mod = 2 ** (depth - 1)
    xp = reflect_pad_to(x, mod)
    compact = extra is not None and extra.shape[-2:] == (1, 1)
    if extra is not None and not compact:
        extra = reflect_pad_to(extra, mod)
    full = extra.expand(-1, -1, *xp.shape[-2:]) if compact else extra
    head_in = (torch.cat([xp, full], 1) if mode in ("input", "both")
               else xp)
    y = _conv(head_in, p, "RNet.head", quant=quant)
    cond = mode in ("down", "both")
    extra_cur = extra
    bridges = []
    for i in range(depth):
        for j in range(arch["n_resblocks"]):
            y = _att_res_block(y, extra_cur if cond else None, p,
                               f"RNet.down_path.{i}.body.{j}", quant)
        if i + 1 < depth:
            bridges.append(y)
            y = _conv(y, p, f"RNet.down_path.{i}.downsampler", stride=2,
                      quant=quant)
            if cond and not compact:
                extra_cur = F.interpolate(extra, size=y.shape[-2:],
                                          mode="nearest")
    for k in range(depth - 1):
        up = f"RNet.up_path.{k}"
        wt = p[f"{up}.upsampler.weight"]
        yin = y
        if quant is not None:
            yin, wt = quant(yin), quant(wt)
        y = F.conv_transpose2d(yin, wt, p[f"{up}.upsampler.bias"], stride=2)
        for b in range(arch["n_resblocks"]):
            y = _att_res_block(y + bridges[depth - 2 - k] if b == 0 else y,
                               None, p, f"{up}.body.{b}", quant)
    out = _conv(y, p, "RNet.tail", quant=quant)[..., :h, :w]
    return out + x


def knet(x, p, arch, quant=None):
    y = _conv(x, p, "KNet.head", stride=4, quant=quant, bias=False)
    for i in range(arch["dep_K"]):
        b = f"KNet.body.{i}.body"
        r = _lrelu(_conv(y, p, f"{b}.0", quant=quant), 0.2)
        r = _conv(r, p, f"{b}.2", quant=quant)
        s = r.mean(dim=(2, 3), keepdim=True)
        s = _lrelu(_conv(s, p, f"{b}.3.body.0", quant=quant), 0.2)
        s = _conv(s, p, f"{b}.3.body.2", quant=quant)
        y = r * torch.sigmoid(s.double()).to(s.dtype) + y
    out = _conv(y, p, "KNet.tail.0", quant=quant).mean(dim=(2, 3))
    o64 = out.double()
    lam = torch.exp(torch.clamp(o64[:, :2], LOG_MIN_KERNEL, LOG_MAX))
    return torch.cat([lam, torch.tanh(o64[:, 2:])], 1).to(out.dtype)


def virnet(x, p, arch, quant=None):
    """Denoising VIRNet: NCHW noisy image -> (mu, sigma)."""
    logits = snet(x, p, arch, quant)
    sigma = torch.exp(torch.clamp(logits.double(), LOG_MIN_SIGMA,
                                  LOG_MAX)).to(x.dtype)
    return rnet(x, torch.sqrt(sigma), p, arch, quant), sigma


def virnet_sr(x, sf, p, arch, quant=None):
    """SISR VIRNet: NCHW LR image -> (mu at sf x the size, kinfo (N, 3),
    sigma (N, 1, 1, 1)); SNet's logits are averaged over the image."""
    logits = snet(x, p, arch, quant).mean(dim=(2, 3), keepdim=True)
    sigma = torch.exp(torch.clamp(logits.double(), LOG_MIN_SIGMA,
                                  LOG_MAX)).to(x.dtype)
    kinfo = knet(x, p, arch, quant)
    x_up = x.repeat_interleave(sf, dim=2).repeat_interleave(sf, dim=3)
    extra = torch.cat([kinfo[:, :, None, None], torch.sqrt(sigma)], 1)
    return rnet(x_up, extra, p, arch, quant), kinfo, sigma


def restore(x_nhwc, p, arch, sf=1, quant=None):
    """What a serving call returns: NHWC float32 in, the restored NHWC
    image clamped to [0, 1] out."""
    x = x_nhwc.permute(0, 3, 1, 2)
    if arch["cls"] == "VIRNetSR":
        mu = virnet_sr(x, sf, p, arch, quant)[0]
    else:
        mu = virnet(x, p, arch, quant)[0]
    return mu.clamp(0.0, 1.0).permute(0, 2, 3, 1)


def fp8_quant(t):
    """Round ``t`` to float8 e4m3 with one scale for the tensor (its
    absolute maximum onto e4m3's 448), back in t's dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    # straight-through: the rounding has no gradient of its own
    return t + (q - t).detach()
