"""Batch pose rendering and image / video artifacts.

Ports nerfail_tpu/render_path.py (the reference's `render_path`,
run_nerf.py:137-175, and the render-only path): render every pose, save
`NNN.png` (to8b) through utils/png, optionally per-image coordinate `.npy`
maps and an mp4. Only the video writer needs `imageio`; it is imported
when a video_path is given, and its absence raises ImportError.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from nerfail_tpu_torch.config import ExperimentConfig
from nerfail_tpu_torch.render import render_full_image
from nerfail_tpu_torch.utils.png import imwrite


def to8b(x: np.ndarray) -> np.ndarray:
    """float [0,1] → uint8 (run_nerf_helpers.py:11)."""
    return (255.0 * np.clip(x, 0.0, 1.0)).astype(np.uint8)


def render_path(
    params: Dict,
    cfg: ExperimentConfig,
    poses: np.ndarray,          # [N, 4, 4] (or [N, 3, 5] llff)
    H: int,
    W: int,
    K: np.ndarray,
    save_dir: Optional[str] = None,
    render_factor: int = 0,
    save_coords: bool = False,
    video_path: Optional[str] = None,
    fps: int = 30,
):
    """Render every pose; returns (rgbs [N,H,W,3], disps [N,H,W]) as numpy.
    `render_factor` renders at 1/factor resolution for previews."""
    if render_factor > 0:
        H, W = H // render_factor, W // render_factor
        K = np.array(K, np.float32)
        K[:2] = K[:2] / render_factor
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    rgbs, disps = [], []
    for i in range(poses.shape[0]):
        out = render_full_image(params["coarse"], params.get("fine"),
                                cfg.model, cfg.render, H, W, K,
                                np.asarray(poses[i][:3, :4], np.float32))
        rgb = out["rgb_map"].cpu().numpy()
        rgbs.append(rgb)
        disps.append(out["disp_map"].cpu().numpy())
        if save_dir:
            imwrite(os.path.join(save_dir, f"{i:03d}.png"), to8b(rgb))
            if save_coords:
                np.save(os.path.join(save_dir, f"{i:03d}.npy"),
                        out["pts_max"].cpu().numpy())
    rgbs, disps = np.stack(rgbs), np.stack(disps)
    if video_path:
        try:
            import imageio.v2 as imageio
        except ImportError as e:
            raise ImportError(
                "render_path(video_path=...): the mp4/GIF video writer "
                "needs imageio, which is not installed") from e

        os.makedirs(os.path.dirname(video_path) or ".", exist_ok=True)
        try:
            imageio.mimwrite(video_path, to8b(rgbs), fps=fps, quality=8)
        except (ValueError, TypeError):
            # no ffmpeg backend → animated GIF
            gif = os.path.splitext(video_path)[0] + ".gif"
            imageio.mimwrite(gif, to8b(rgbs), duration=1000.0 / fps)
    return rgbs, disps
