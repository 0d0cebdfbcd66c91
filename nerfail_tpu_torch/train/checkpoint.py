"""Checkpoint save/resume.

Ports nerfail_tpu/train/checkpoint.py. The JAX package writes msgpack
pytree snapshots; the port writes `torch.save` files of nested dicts of
tensors (state dicts) and plain values. File naming keeps the reference's
zero-padded step convention (run_nerf.py:216-233), and every write is an
atomic replace, so a reader sees a whole checkpoint or none.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch


def _to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_checkpoint(path: str, state: Any) -> str:
    """Write `state` (nested dicts/lists of tensors and plain values) to
    `path`, tensors moved to the CPU."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, map_location: Any = "cpu") -> Any:
    """The state saved at `path`, tensors on `map_location`."""
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(logdir: str, suffix: str = ".ckpt") -> Optional[str]:
    """Latest step-numbered checkpoint in a directory (reference scans for
    '*.tar' and takes the last — run_nerf.py:216-224)."""
    if not os.path.isdir(logdir):
        return None
    pat = re.compile(r"^(\d+)" + re.escape(suffix) + "$")
    found: List[tuple] = []
    for name in os.listdir(logdir):
        m = pat.match(name)
        if m:
            found.append((int(m.group(1)), name))
    if not found:
        return None
    found.sort()
    return os.path.join(logdir, found[-1][1])


def checkpoint_path(logdir: str, step: int, suffix: str = ".ckpt") -> str:
    return os.path.join(logdir, f"{step:06d}{suffix}")
