"""Camera-ray generation on the host.

Semantics match the reference `get_rays_np` (run_nerf_helpers.py:157-196):
OpenGL-style camera with +x right, +y up, -z forward; pixel (i, j) maps to
direction ((i-cx)/fx, -(j-cy)/fy, -1) rotated by c2w. The slice needs only
the numpy form, for scene generation and coordinate maps.
"""

from __future__ import annotations

import numpy as np


def get_rays_np(H: int, W: int, K: np.ndarray, c2w: np.ndarray):
    """Per-pixel rays (rays_o, rays_d), each [H, W, 3]."""
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
