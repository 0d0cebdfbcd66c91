"""Distance → Gaussian splat weights.

Matches `create_gauss_w` (model/GaussNet.py:161-186):

    w_j   = exp(-(d_j / c)² / 2),  c = 0.02
    W     = Σ_j w_j over the k neighbors
    out_j = w_j / (W + 0.001)   where W > 0, else 0
"""

from __future__ import annotations

import torch


def gauss_weights(dist: torch.Tensor, c: float = 0.02,
                  eps: float = 0.001) -> torch.Tensor:
    w = torch.exp(-((dist / c) ** 2) / 2.0)
    wsum = torch.sum(w, dim=-1, keepdim=True)
    out = w / (wsum + eps)
    return torch.where(wsum > 0.0, out, torch.zeros_like(out))
