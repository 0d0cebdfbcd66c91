"""Camera pose utilities: the spherical spiral used for render videos.

Same math as the reference's `pose_spherical` helpers
(load_blender.py:17-34): translate along z, rotate by phi about x,
by theta about y, then flip into the blender world convention. Host
numpy, as in the JAX package, so both produce bit-equal poses.
"""

from __future__ import annotations

import numpy as np


def _trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(phi), np.sin(phi)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rot_theta(th: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(th), np.sin(th)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """c2w 4×4 for camera at (theta°, phi°) on a sphere of given radius."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    return flip @ c2w


def render_spiral_poses(
    n: int = 40, phi: float = -30.0, radius: float = 4.0
) -> np.ndarray:
    """[n, 4, 4] spiral of poses at fixed elevation (load_blender.py:87)."""
    thetas = np.linspace(-180.0, 180.0, n + 1)[:-1]
    return np.stack([pose_spherical(t, phi, radius) for t in thetas], axis=0)
