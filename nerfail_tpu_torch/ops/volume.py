"""Volume-rendering compositing (the reference's `raw2outputs`).

Numerics match nerfail_tpu/ops/volume.py and run_nerf.py:262-305:
  dists   = z[i+1] - z[i], sentinel 1e10 for the last sample, scaled by |d|
  alpha   = 1 - exp(-relu(sigma + noise) · dist)
  T       = exclusive cumprod of (1 - alpha + 1e-10)
  weights = alpha · T
  rgb_map = Σ w · sigmoid(rgb_raw);  white_bkgd adds (1 - acc)
  disp    = 1 / max(1e-10, depth / max(acc, 1e-10))   (guarded: no 0/0)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """cumprod shifted right by one with a leading 1 (run_nerf.py:295)."""
    n = x.shape[dim]
    ones = torch.ones_like(x.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([ones, x.narrow(dim, 0, n - 1)], dim=dim),
                         dim=dim)


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Composite raw MLP outputs along each ray. raw [N, S, 4] (rgb logits
    + sigma), z_vals [N, S], rays_d [N, 3]. Noise on sigma is `noise` when
    injected, else drawn from `generator` when raw_noise_std > 0."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if noise is None and raw_noise_std > 0.0 and generator is not None:
        noise = torch.randn(sigma.shape, generator=generator,
                            dtype=sigma.dtype,
                            device=sigma.device) * raw_noise_std
    if noise is not None:
        sigma = sigma + noise

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    transmittance = exclusive_cumprod(1.0 - alpha + 1e-10, dim=-1)
    weights = alpha * transmittance

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(
        depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb_map": rgb_map, "disp_map": disp_map, "acc_map": acc_map,
            "weights": weights, "depth_map": depth_map}
