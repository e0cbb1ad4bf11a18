"""The device trace of a short fixed tail of a run: torch.profiler (CUPTI)
over a number of requests or steps, reduced to what the per-layer readers
and the result's ``breakdown`` need.

Kernel groups follow the program's smoke run (its ``GROUPS`` and
``TRAIN_GROUPS``): the port's own kernels by name, library convolutions
and matrix products (cuDNN, cuBLAS, CUTLASS), copies and fills, and the
rest, PyTorch's elementwise and reduction kernels.
"""

from __future__ import annotations

import bisect
import time

import torch

OURS = ("dncnn_head_", "snet_conv1", "snet_last", "tail_kernel",
        "conv3x3_mid_", "blur_valid_kernel", "blur_dx_kernel",
        "blur_dw_kernel", "blur_dw_reduce", "conv_q8", "absmax_")
LIBRARY = ("conv", "cudnn", "xmma", "gemm", "cutlass", "implicit")
COPIES = ("memcpy", "memset")


def kind(name: str) -> str:
    """'ours', 'library', 'copy' or 'elementwise' (the first match wins)."""
    low = name.lower()
    if any(k in name for k in OURS):
        return "ours"
    if any(k in low for k in COPIES):
        return "copy"
    if any(k in low for k in LIBRARY):
        return "library"
    return "elementwise"


class Trace:
    """Device activity of ``units`` calls: ``ops`` [(name, start_us,
    end_us)] on the device, ``host`` [(name, start_us, end_us)] of the
    host's operators (where recorded), and the host-clock ``window_s`` of
    the traced calls (from the first call to the synchronisation after the
    last).  ``gaps_from`` is the trace whose host operators attribute the
    idle gaps."""

    def __init__(self, ops, host, units, window_s):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.host = host
        self.units = units
        self.window_s = window_s
        self.gaps_from = self

    def ms_per_unit(self, pred) -> float:
        """Device ms a call in the operations whose name ``pred`` takes."""
        return sum(e - s for n, s, e in self.ops if pred(n)) / 1e3 / self.units

    def busy_intervals(self) -> list:
        merged: list = []
        for _, s, e in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, in seconds over the
        traced calls, and the idle gaps summed by the host operator that
        was running inside them (the innermost one over the gap's middle),
        in seconds over the calls ``gaps_from`` traced with the host."""
        by_op: dict = {}
        for n, s, e in self.ops:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
        gaps: dict = {}
        src = self.gaps_from
        host = sorted(src.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        busy = src.busy_intervals()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            name = _host_at(host, starts, 0.5 * (e0 + s1))
            gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6

        def top_of(d):
            return [[k[:120], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return dict(device_ops=top_of(by_op), idle_gaps=top_of(gaps))


def _host_at(host, starts, t, look: int = 4000) -> str:
    """The innermost host operator running at ``t``: of those that contain
    it, the one that started last (operators nest)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - look, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "(no host operator)"


def _session(call, first: int, units: int, device, host: bool):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    sync(device)
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + units):
            call(i)
        sync(device)
        window_s = time.perf_counter() - t0
    ops, host_ops = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue        # a record_function range, not device work
        span = (e.name, e.time_range.start, e.time_range.end)
        (ops if e.device_type == DeviceType.CUDA else host_ops).append(span)
    return Trace(ops, host_ops, units, window_s)


def profile(call, units: int, device, host_units: int = 2) -> Trace:
    """``call(i)`` for i in range(units) under the profiler recording the
    device alone (so that its own host cost stays small), then
    ``host_units`` calls more recording the host's operators too, which
    only the idle gaps' attribution reads; every call's work is
    synchronised with the device before its trace ends."""
    trace = _session(call, 0, units, device, host=False)
    with_host = _session(call, units, host_units, device, host=True)
    trace.gaps_from = with_host
    return trace


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
