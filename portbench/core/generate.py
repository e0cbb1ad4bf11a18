"""The one generator of every cell's inputs, from a traffic file's
parameters and the run's seed.

Everything is drawn on the run's device from one ``torch.Generator`` in a
few large calls, so that set-up stays short and the same seed gives the
same inputs.  A seed may be any whole number up to a little over 2**31
and beyond; it is folded into the generator's 64-bit range.

Images are photograph-like: per channel a sum of six low-frequency cosines
(the program's smoke run's smooth images), four random half-planes that
give hard edges, and N(0, 0.03) texture, clipped to [0, 1].
"""

from __future__ import annotations

import math

import torch

N_COSINES = 6
N_EDGES = 4


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` and one of several streams."""
    mixed = (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def _u(g, lo, hi, shape, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def photo_images(g, n: int, h: int, w: int, device,
                 chunk: int = 32) -> torch.Tensor:
    """(n, h, w, 3) float32 photograph-like images in [0, 1]."""
    out = torch.empty(n, h, w, 3, device=device)
    scale = float(max(h, w))
    yy = (torch.arange(h, device=device) / scale).view(1, 1, 1, h, 1)
    xx = (torch.arange(w, device=device) / scale).view(1, 1, 1, 1, w)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        f = _u(g, 0.5, 4.0, (m, 3, N_COSINES, 2, 1, 1), device)
        ph = _u(g, 0.0, 2 * math.pi, (m, 3, N_COSINES, 1, 1), device)
        amp = _u(g, 0.2, 1.0, (m, 3, N_COSINES, 1, 1), device)
        im = (amp * torch.cos(2 * math.pi * (f[:, :, :, 0] * yy
                                             + f[:, :, :, 1] * xx) + ph)
              ).sum(2)                                        # m, 3, h, w
        theta = _u(g, 0.0, 2 * math.pi, (m, N_EDGES, 1, 1), device)
        off = _u(g, 0.2, 0.8, (m, N_EDGES, 1, 1), device)
        step = _u(g, -1.0, 1.0, (m, N_EDGES, 3, 1, 1), device)
        side = ((torch.cos(theta) * yy[:, 0] + torch.sin(theta) * xx[:, 0]
                 ) > off).float()                             # m, E, h, w
        im = im + (step * side[:, :, None]).sum(1)
        lo = im.amin(dim=(1, 2, 3), keepdim=True)
        hi = im.amax(dim=(1, 2, 3), keepdim=True)
        im = 0.1 + 0.8 * (im - lo) / (hi - lo)
        im = im + 0.03 * torch.randn(im.shape, generator=g, device=device)
        out[s:s + m] = im.clamp(0.0, 1.0).permute(0, 2, 3, 1)
    return out


def niid_noise(g, clean: torch.Tensor, level) -> torch.Tensor:
    """``clean`` plus Gaussian noise whose standard deviation varies over
    each image: a Gaussian bump between two levels drawn in ``level`` (on
    the 0-255 scale), as the synthetic-denoising training draws it."""
    n, h, w, _ = clean.shape
    dev = clean.device
    center = _u(g, 0.0, 1.0, (n, 2, 1, 1), dev) * torch.tensor(
        [h, w], device=dev).view(1, 2, 1, 1)
    spread = _u(g, 0.25, 0.75, (n, 1, 1), dev) * max(h, w)
    ends = _u(g, level[0] / 255.0, level[1] / 255.0, (n, 2), dev)
    lo, hi = ends.amin(1).view(n, 1, 1), ends.amax(1).view(n, 1, 1)
    yy = torch.arange(h, device=dev).view(1, h, 1)
    xx = torch.arange(w, device=dev).view(1, 1, w)
    bump = torch.exp(-((yy - center[:, 0]) ** 2 + (xx - center[:, 1]) ** 2)
                     / (2 * spread ** 2))
    bump = bump / bump.amax(dim=(1, 2), keepdim=True)
    sigma = lo + (hi - lo) * bump
    return clean + sigma[..., None] * torch.randn(clean.shape, generator=g,
                                                  device=dev)


def iid_noise(g, clean: torch.Tensor, level) -> torch.Tensor:
    """``clean`` plus Gaussian noise of one level per image, drawn in
    ``level`` (0-255 scale)."""
    n = clean.shape[0]
    sd = _u(g, level[0] / 255.0, level[1] / 255.0, (n, 1, 1, 1), clean.device)
    return clean + sd * torch.randn(clean.shape, generator=g,
                                    device=clean.device)


def request_images(spec: dict, seed: int, device) -> dict:
    """The pool of a serving mix: {(h, w): (pool, batch, h, w, 3) float32
    on the host}, one entry per shape of ``spec['shapes']``."""
    g = generator(seed, device, 1)
    pools = {}
    for h, w in spec["shapes"]:
        n = spec["pool"] * spec["batch"]
        im = photo_images(g, n, h, w, device)
        im = (niid_noise if spec["noise"] == "niid" else iid_noise)(
            g, im, spec["noise_level"])
        pools[(h, w)] = im.view(spec["pool"], spec["batch"], h, w,
                                3).cpu().numpy()
    return pools


def records(spec: dict, seed: int, device) -> torch.Tensor:
    """(n, size, size, 3) uint8 photograph-like records on ``device``."""
    g = generator(seed, device, 2)
    im = photo_images(g, spec["records"], spec["record_size"],
                      spec["record_size"], device)
    return torch.round(im * 255.0).to(torch.uint8)


def sisr_step_draws(spec: dict, train: dict, seed: int, device) -> list:
    """``spec['draw_sets']`` sets of every random number of one SISR
    training step at the configuration's batch: the crop (record, offsets,
    dihedral mode), the degradation (kernel shape, noise level, LR noise)
    and the ELBO's (Gamma draws, correlation noise, the z noise), with the
    distributions of the reference's training data and loss."""
    g = generator(seed, device, 3)
    b, hr, sf = train["batch_size"], train["hr_size"], train["sf"]
    lr = math.ceil(hr / sf)
    size = spec["record_size"]
    lo, hi = train["noise_level"]
    kappa0 = float(train["kappa0"])
    sets = []
    for _ in range(spec["draw_sets"]):
        def randint(top):
            return torch.randint(0, top, (b,), generator=g, device=device)

        sample = dict(mode=randint(8), idx=randint(spec["records"]),
                      oh=randint(size - hr + 1), ow=randint(size - hr + 1))
        synth = dict(lam1=_u(g, 0.2, float(sf), (b,), device),
                     lam2_u=_u(g, 0.0, 1.0, (b,), device),
                     iso_u=_u(g, 0.0, 1.0, (b,), device),
                     theta=_u(g, 0.0, math.pi, (b,), device),
                     nlevel=_u(g, lo / 255.0, hi / 255.0, (b,), device),
                     noise=torch.randn((b, lr, lr, 3), generator=g,
                                       device=device))
        elbo = dict(gamma_draw=torch._standard_gamma(
                        torch.full((b, 2), kappa0 - 1.0, device=device),
                        generator=g),
                    rho_eps=torch.randn((b,), generator=g, device=device),
                    z_eps=torch.randn((b, hr, hr, 3), generator=g,
                                      device=device))
        sets.append(dict(sample=sample, synth=synth, elbo=elbo))
    return sets
