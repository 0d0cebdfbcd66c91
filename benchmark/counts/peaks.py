"""Published peaks of the cards the benchmark runs on, and the card's
power limit as `nvidia-smi` reports it.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
limit: bf16 989 TFLOP/s, fp32 67 TFLOP/s outside the tensor cores, HBM3
3.35 TB/s. A card set below 700 W runs slower under load; every share is
stated against these peaks with the limit beside it.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Peaks:
    bytes_per_s: float
    fp32: float
    bf16: float


H100_SXM = Peaks(bytes_per_s=3.35e12, fp32=67e12, bf16=989e12)

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_of(device_name: str) -> Peaks:
    """The peaks of a card by `torch.cuda.get_device_name`; raises for a
    card without published figures here."""
    if device_name not in PEAKS:
        raise KeyError(f"no published peaks for {device_name!r}")
    return PEAKS[device_name]


def power_limit_w() -> Optional[float]:
    """The first card's power limit in W, or None where nvidia-smi cannot
    say."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (subprocess.SubprocessError, ValueError, IndexError):
        return None


def bound_seconds(flops: float, nbytes: float, peak_flops: float,
                  peaks: Peaks) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / peaks.bytes_per_s)
