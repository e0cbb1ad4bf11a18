"""The card: its presence, name, power limit, memory and data-sheet peaks.

The peaks are NVIDIA's data-sheet figures (dense, without sparsity), as the
program's smoke run keeps them: bf16 tensor-core FLOP/s, fp32 FLOP/s on
the CUDA cores (the fp32 compute runs with TF32 off), int8 tensor-core
OP/s and memory bytes/s.  They assume the full power limit; the limit the
card is set to is read beside them.
"""

from __future__ import annotations

import subprocess

import torch

PEAKS = {
    "H100 SXM": dict(bf16=989e12, fp32=67e12, int8=1979e12, bytes=3.35e12),
    "H100 PCIe": dict(bf16=756e12, fp32=51e12, int8=1513e12, bytes=2.0e12),
    "H100 NVL": dict(bf16=835e12, fp32=60e12, int8=1671e12, bytes=3.9e12),
}


class NoCard(RuntimeError):
    pass


def require(chips: int) -> torch.device:
    """The first card, or NoCard when there are fewer than ``chips``."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def peaks(device) -> dict:
    """The data-sheet peaks of ``device``'s part (SXM unless its name says
    PCIe or NVL)."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[f"H100 {key}"]
    return PEAKS["H100 SXM"]


def power_limit_w(device) -> float | None:
    """The power limit the card is set to, in W (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()
        return float(out[device.index or 0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device, chips: int, memory_peak_bytes: int) -> dict:
    """The result's ``device`` object, without the traced run's keys."""
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=chips,
                    memory_peak_bytes=memory_peak_bytes)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips, memory_peak_bytes=memory_peak_bytes,
                power_limit_w=power_limit_w(device))
