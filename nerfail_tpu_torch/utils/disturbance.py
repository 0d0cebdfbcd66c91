"""Perturbation-mask visualization — tools/inverted_disturbance.py parity.

Ports nerfail_tpu/utils/disturbance.py: inverts a mask PNG's colors and
alpha so faint perturbations become visible on white paper/figures.
"""

from __future__ import annotations

import numpy as np

from nerfail_tpu_torch.utils.png import imread, imwrite


def invert_disturbance(rgba: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8/float 0-255 → inverted colors + inverted alpha."""
    out = rgba.astype(np.float32).copy()
    out[..., :3] = 255.0 - out[..., :3]
    out[..., 3] = 255.0 - out[..., 3]
    return out


def invert_disturbance_file(in_path: str, out_path: str) -> None:
    img = imread(in_path)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full_like(img[..., :1], 255)], axis=-1
        )
    imwrite(out_path, invert_disturbance(img).astype(np.uint8))
