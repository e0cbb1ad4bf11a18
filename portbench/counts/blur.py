"""The per-sample blur of a SISR training step (csrc/blur.cu): K5 twice
(the synthesis' blur and the ELBO's), K6 (the ELBO blur's dX) and K7 with
its reduce (its dW), f32 on the CUDA cores, at the step's HR batch: each
2 FLOPs per tap and output or cotangent element, each input read and each
output written once (the counts of the program's smoke run, chip_smoke.py
blur_kernels)."""

KERNELS = ("blur_valid_kernel", "blur_dx_kernel", "blur_dw_kernel",
           "blur_dw_reduce")


def work(cell):
    t = cell.config["train"]
    n, h, k, c = t["batch_size"], t["hr_size"], t["k_size"], 3
    hp = h + k - 1
    flops = 2 * n * c * h * h * k * k
    xp, img, kern = n * hp * hp * c, n * h * h * c, n * k * k
    forward = (flops, 4 * (xp + kern + img), "fp32")
    return [forward, forward,
            (flops, 4 * (img + kern + xp), "fp32"),     # K6: g -> dxp
            (flops, 4 * (xp + img + kern), "fp32")]     # K7: xp, g -> dW
