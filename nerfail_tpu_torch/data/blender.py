"""Blender-format scene helpers (nerfail_tpu/data/blender.py). Only the
white-background composite is ported; the loaders are still to come."""

from __future__ import annotations

import numpy as np


def white_background_composite(images: np.ndarray) -> np.ndarray:
    """RGBA [.., 4] in [0,1] → RGB on white: rgb·a + (1-a) (run_nerf.py:578).
    RGB inputs (LLFF/DeepVoxels, no alpha) pass through unchanged."""
    if images.shape[-1] == 3:
        return images
    return images[..., :3] * images[..., 3:4] + (1.0 - images[..., 3:4])
