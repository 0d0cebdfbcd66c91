"""Device selection for the port's entry points.

Every entry point takes an explicit `device` that defaults to the card.
There is no silent CPU fallback: asking for CUDA on a machine without a
card raises, and the CPU is used only when the caller passes "cpu".
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
