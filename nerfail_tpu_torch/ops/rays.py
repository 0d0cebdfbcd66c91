"""Camera-ray generation and the NDC reparameterization.

Semantics match the reference `get_rays`/`get_rays_np`/`ndc_rays`
(run_nerf_helpers.py:157-196): OpenGL-style camera with +x right, +y up,
-z forward; pixel (i, j) maps to direction ((i-cx)/fx, -(j-cy)/fy, -1)
rotated by c2w. `get_rays_np` serves host-side scene generation and
coordinate maps; `get_rays` builds the renderer's rays on a device.
"""

from __future__ import annotations

import numpy as np
import torch


def get_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Per-pixel rays (rays_o, rays_d), each [H, W, 3], on c2w's device.
    The rotation is three f32 products summed elementwise, never a reduced
    precision matrix product."""
    dev = c2w.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    c2w = c2w.to(torch.float32)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
         -torch.ones_like(i)], dim=-1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, K: np.ndarray, c2w: np.ndarray):
    """Per-pixel rays (rays_o, rays_d), each [H, W, 3], in numpy."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    dirs = np.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -np.ones_like(i)],
        axis=-1,
    )
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], axis=-1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Shift rays to the z=-near plane and map to NDC (forward-facing LLFF)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return (torch.stack([o0, o1, o2], dim=-1),
            torch.stack([d0, d1, d2], dim=-1))
