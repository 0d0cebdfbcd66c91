"""What the NeRF engines share: the port's configuration from the cell's
file, and the gaps between the program's readings and the reference's."""

from __future__ import annotations

from typing import List, Sequence

import torch

from nerfail_tpu_torch.config import (
    ExperimentConfig, NeRFModelConfig, RenderConfig, TrainConfig,
)


def program_config(cfg: dict) -> ExperimentConfig:
    m, r, t = dict(cfg["model"]), dict(cfg["render"]), dict(cfg["train"])
    m["skips"] = tuple(m["skips"])
    return ExperimentConfig(model=NeRFModelConfig(**m),
                            render=RenderConfig(**r), train=TrainConfig(**t))


def median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def norm_gap(prog: List[torch.Tensor], ref: List[torch.Tensor],
             counted: Sequence[bool] = (), worst: bool = True) -> float:
    """The worst (or, with worst=False, the median) leaf's gap between the
    program's norm and the reference's, over the larger of that leaf's
    reference norm and the median leaf's. `counted` leaves others out."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    if len(pn) != len(rn):
        return float("inf")
    med = median(rn)
    keep = list(counted) or [True] * len(rn)
    gaps = [abs(a - b) / max(b, med) for a, b, k in zip(pn, rn, keep) if k]
    if not gaps:
        return float("inf")
    return max(gaps) if worst else median(gaps)
