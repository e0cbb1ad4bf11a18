"""Profiling (counterpart of virnet_tpu/eval/profiling.py): a
torch.profiler trace of a block, written as a Chrome trace, and named
regions inside it; timing that ends in a synchronisation is
eval/analysis.py:measure_time."""

from __future__ import annotations

import tempfile
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextmanager
def trace(log_dir=None):
    """Profile the block (the card's kernels too, when there is one) and
    write ``<log_dir>/trace.json``, viewable in Perfetto or
    chrome://tracing; yields the profiler (``key_averages()`` for sums by
    kernel).  ``log_dir`` defaults to a folder under the temp dir::

        with trace("runs/trace") as prof:
            restorer.restore_batch(x)
    """
    log_dir = Path(log_dir or Path(tempfile.gettempdir())
                   / "virnet_tpu_torch_trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """A named region inside a trace (torch.profiler.record_function)."""
    return record_function(name)
