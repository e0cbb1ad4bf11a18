"""Device ms a request in PyTorch's own kernels: neither a library
convolution or matrix product, nor a kernel of the port, nor a copy
(core/trace.py:kind).  In bf16 the RNet body's separate bias, LeakyReLU
and residual passes; in fp32 also im2col's unfold."""

from portbench.core.trace import kind


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_unit(lambda n: kind(n) == "elementwise")
    return ms if ms > 0 else None
