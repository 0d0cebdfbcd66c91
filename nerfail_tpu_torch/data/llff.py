"""LLFF forward-facing scene loader (a numpy copy of nerfail_tpu/data/llff.py;
images read by utils/png).

Capability parity with the reference `load_llff_data`
(Create_spatial_point_set/nerf_pytorch/load_llff.py:243-319): reads
`poses_bounds.npy` ([N, 17] = 3×5 pose+hwf + 2 depth bounds), loads the
image set, rescales bounds by `bd_factor`, recenters poses, and generates
a spiral (or spherified) render path. Image minification uses numpy
area-averaging instead of the reference's ImageMagick subprocess.

Internals diverge from the LLFF lineage on purpose: all pose math runs on
plain [N, 3, 4] camera-to-world matrices (the 3×5 hwf-column convention
exists only at the `LLFFScene` boundary for API parity), and the spiral /
spherified render paths are vectorized over the path angle instead of
per-pose python loops. Numerics match the reference (tests/test_llff.py
checks recentering and path invariants).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from nerfail_tpu_torch.utils.png import imread


def _imread(path: str) -> np.ndarray:
    return imread(path).astype(np.float32) / 255.0


def _area_resize(img: np.ndarray, factor: int) -> np.ndarray:
    H = img.shape[0] // factor * factor
    W = img.shape[1] // factor * factor
    img = img[:H, :W]
    return img.reshape(
        H // factor, factor, W // factor, factor, -1
    ).mean(axis=(1, 3))


# --------------------------------------------------------------- pose math
# Conventions: c2w [..., 3, 4] with columns (x=right, y=up, z=back, t);
# every helper is batched over leading axes.


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def camera_frame(back: np.ndarray, up_hint: np.ndarray,
                 pos: np.ndarray) -> np.ndarray:
    """Right-handed camera frame(s) [..., 3, 4] from a viewing 'back'
    direction (+z, away from the target), an approximate up vector, and a
    position. x = up×z, y = z×x — Gram-Schmidt around the back axis."""
    z = _unit(back)
    x = _unit(np.cross(up_hint, z))
    y = _unit(np.cross(z, x))
    return np.stack([x, y, z, pos], axis=-1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """The 'central' camera [3, 4]: mean position, mean viewing direction,
    mean up — the frame the spiral path orbits and recentering maps to
    the identity."""
    center = poses[:, :3, 3].mean(0)
    back = _unit(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return camera_frame(back, up, center)


def _to_4x4(p34: np.ndarray) -> np.ndarray:
    """[..., 3, 4] → [..., 4, 4] homogeneous."""
    shape = p34.shape[:-2]
    bottom = np.broadcast_to(
        np.array([0, 0, 0, 1.0], p34.dtype), shape + (1, 4)
    )
    return np.concatenate([p34, bottom], axis=-2)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Re-express all poses [N, 3, 4] in the average camera's frame (the
    mean camera becomes the identity pose) — one batched matmul."""
    world_from_avg = _to_4x4(average_pose(poses))
    return (np.linalg.inv(world_from_avg) @ _to_4x4(poses))[:, :3, :4]


def spiral_path(
    c2w: np.ndarray,            # [3, 4] central camera
    up: np.ndarray,             # world up
    rads: np.ndarray,           # [3] xyz orbit radii
    focal: float,               # look-at depth along the central -z
    zrate: float = 0.5,
    rots: float = 2.0,
    n: int = 120,
) -> np.ndarray:
    """[n, 3, 4] spiral of cameras around the central pose, all looking at
    the point `focal` units in front of it (the forward-facing render
    path). Vectorized over the angle."""
    theta = np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]
    # orbit offsets in the central camera's coordinates
    local = np.stack(
        [np.cos(theta) * rads[0],
         -np.sin(theta) * rads[1],
         -np.sin(theta * zrate) * rads[2]], axis=-1,
    )                                                       # [n, 3]
    centers = local @ c2w[:3, :3].T + c2w[:3, 3]            # [n, 3]
    target = c2w[:3, 3] - focal * c2w[:3, 2]
    back = centers - target                                 # +z away from it
    return camera_frame(back, np.broadcast_to(up, back.shape), centers)


def _nearest_point_to_rays(origins: np.ndarray,
                           dirs: np.ndarray) -> np.ndarray:
    """Least-squares point minimizing distance to all rays (o_i, d_i):
    solve (Σ P_i)x = Σ P_i o_i with P_i = I − d_i d_iᵀ."""
    d = _unit(dirs)
    P = np.eye(3) - d[..., :, None] * d[..., None, :]       # [N, 3, 3]
    return np.linalg.solve(P.sum(0), (P @ origins[..., None]).sum(0))[:, 0]


def spherify_poses(
    poses: np.ndarray, bds: np.ndarray, n: int = 120,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-frame an inward-facing capture onto the unit sphere and build a
    circular render path at the capture's mean height.

    Returns (poses [N, 3, 4], render_poses [n, 3, 4], scaled bds). The
    world frame is moved to the point nearest all optical axes, scaled so
    the mean camera distance is 1, and the render cameras sit on the
    resulting circle looking at the origin. (The render frames keep the
    standard up orientation; the reference's spherified path builds its
    frame with the opposite cross-product order, i.e. a cosmetic 180°
    camera roll, load_llff.py:216-223.)"""
    center = _nearest_point_to_rays(poses[:, :3, 3], poses[:, :3, 2])
    up = _unit((poses[:, :3, 3] - center).mean(0))
    # any frame with +z along `up`; the fixed hint keeps it deterministic
    x = _unit(np.cross([0.1, 0.2, 0.3], up))
    y = _unit(np.cross(up, x))
    world_from_center = _to_4x4(np.stack([x, y, up, center], axis=-1))
    poses_reset = (np.linalg.inv(world_from_center)
                   @ _to_4x4(poses))[:, :3, :4]

    rad = float(np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, -1))))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc

    zh = poses_reset[:, :3, 3].mean(0)[2]
    radcircle = np.sqrt(max(1.0 - zh * zh, 0.0))
    theta = np.linspace(0.0, 2.0 * np.pi, n)
    centers = np.stack(
        [radcircle * np.cos(theta), radcircle * np.sin(theta),
         np.full_like(theta, zh)], axis=-1,
    )
    render = camera_frame(
        centers, np.broadcast_to([0.0, 0.0, -1.0], centers.shape), centers
    )
    return poses_reset, render, bds


# ----------------------------------------------------------------- loading


@dataclass
class LLFFScene:
    images: np.ndarray       # [N, H, W, 3] float [0,1]
    poses: np.ndarray        # [N, 3, 5] (pose + hwf column)
    bds: np.ndarray          # [N, 2]
    render_poses: np.ndarray
    i_test: int
    H: int
    W: int
    focal: float


def _with_hwf(poses: np.ndarray, h: int, w: int, f: float) -> np.ndarray:
    """Append the reference's [h, w, f] column: [..., 3, 4] → [..., 3, 5]."""
    hwf = np.broadcast_to(
        np.array([h, w, f], np.float32)[:, None], poses.shape[:-2] + (3, 1)
    )
    return np.concatenate([poses.astype(np.float32), hwf], axis=-1)


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    width: Optional[int] = None,
    height: Optional[int] = None,
    path_zflat: bool = False,
) -> LLFFScene:
    """`width`/`height` override `factor` by deriving it from the source
    resolution (the reference's _minify resolution targets,
    load_llff.py:77-87); `path_zflat` flattens the spiral render path to a
    single half-length rotation at fixed z (load_llff.py:291-298)."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    raw = poses_arr[:, :-2].reshape([-1, 3, 5])             # [N, 3, 5]
    bds = poses_arr[:, -2:].astype(np.float32)              # [N, 2]

    imgdir = os.path.join(basedir, "images")
    img_files = sorted(
        f for f in os.listdir(imgdir)
        if f.lower().endswith(("jpg", "jpeg", "png"))
    )
    first = _imread(os.path.join(imgdir, img_files[0]))
    if height is not None:
        factor = max(int(round(first.shape[0] / float(height))), 1)
    elif width is not None:
        factor = max(int(round(first.shape[1] / float(width))), 1)
    imgs = []
    for f in img_files:
        im = _imread(os.path.join(imgdir, f))[..., :3]
        if factor > 1:
            im = _area_resize(im, factor)
        imgs.append(im)
    images = np.stack(imgs, 0).astype(np.float32)           # [N, H, W, 3]

    H, W = images.shape[1:3]
    focal = float(raw[0, 2, 4]) / factor

    # LLFF stores [down right back] columns; swap to [right up back]
    poses = np.concatenate(
        [raw[:, :, 1:2], -raw[:, :, 0:1], raw[:, :, 2:4]], axis=-1
    ).astype(np.float32)                                    # [N, 3, 4]

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = average_pose(poses)
        up = _unit(poses[:, :3, 1].sum(0))
        # path look-at depth from the scene's depth bounds, orbit radii
        # from the 90th percentile of camera offsets (reference heuristics,
        # load_llff.py:281-297)
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        path_focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
        rots, n_path = 2.0, 120
        if path_zflat:
            # flat half-orbit at a slightly backed-off z
            # (load_llff.py:291-298)
            c2w = c2w.copy()
            c2w[:3, 3] -= close_depth * 0.1 * c2w[:3, 2]
            rads = rads.copy()
            rads[2] = 0.0
            rots, n_path = 1.0, 60
        render_poses = spiral_path(
            c2w, up, rads, path_focal, zrate=0.5, rots=rots, n=n_path,
        )

    dists = np.sum((average_pose(poses)[:3, 3] - poses[:, :3, 3]) ** 2, -1)
    i_test = int(np.argmin(dists))
    return LLFFScene(
        images=images,
        poses=_with_hwf(poses, H, W, focal),
        bds=bds,
        render_poses=_with_hwf(render_poses, H, W, focal),
        i_test=i_test, H=H, W=W, focal=focal,
    )
