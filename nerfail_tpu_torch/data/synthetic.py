"""Procedural box scene with analytic surface coordinates.

A colored axis-aligned box rendered by exact ray/box intersection on a
transparent background, in the in-memory layout the blender loader
returns. `analytic_coord_map` gives the exact per-pixel surface point,
the ground-truth stand-in for a NeRF's `pts_max`, so the attack slice runs
without fitting a NeRF. `make_forward_scene` is its forward-facing
variant, and `write_blender_format` / `write_llff_format` put either on
disk in the layouts the loaders read. Host numpy, bit-equal to the JAX
package's copy.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from nerfail_tpu_torch.data.blender import BlenderScene
from nerfail_tpu_torch.data.poses import pose_spherical, render_spiral_poses
from nerfail_tpu_torch.ops.rays import get_rays_np
from nerfail_tpu_torch.utils.png import imwrite


BOX_MIN = np.array([-0.6, -0.6, -0.6], np.float32)
BOX_MAX = np.array([0.6, 0.6, 0.6], np.float32)


def _ray_box(o: np.ndarray, d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Slab-method intersection; returns (t_near, hit_mask) per ray."""
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0 = (BOX_MIN - o) * inv
    t1 = (BOX_MAX - o) * inv
    tmin = np.minimum(t0, t1).max(axis=-1)
    tmax = np.maximum(t0, t1).min(axis=-1)
    hit = (tmax > np.maximum(tmin, 0.0))
    return tmin, hit


def class_palette(variant: int = 0) -> np.ndarray:
    """Six face colors for scene-class `variant` (0 is the original)."""
    if variant == 0:
        return np.array(
            [
                [0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9],
                [0.9, 0.9, 0.2], [0.9, 0.2, 0.9], [0.2, 0.9, 0.9],
            ],
            np.float32,
        )
    rng = np.random.default_rng(1000 + variant)
    return rng.uniform(0.15, 0.95, (6, 3)).astype(np.float32)


def _shade(o: np.ndarray, d: np.ndarray, variant: int = 0) -> np.ndarray:
    """RGBA [N,4] in [0,1]: face-colored box, transparent background."""
    t, hit = _ray_box(o, d)
    p = o + t[..., None] * d
    # color by dominant face normal → six distinct colors
    rel = (p - (BOX_MIN + BOX_MAX) / 2) / ((BOX_MAX - BOX_MIN) / 2)
    axis = np.argmax(np.abs(rel), axis=-1)
    sign = np.take_along_axis(np.sign(rel), axis[..., None], axis=-1)[..., 0]
    palette = class_palette(variant)
    face = axis * 2 + (sign > 0).astype(np.int64)
    rgb = palette[face]
    # cheap lambert-ish shading along view dir for texture
    shade = 0.7 + 0.3 * np.clip(-d @ np.array([0.3, 0.5, 0.8]), 0, 1)[..., None]
    rgba = np.concatenate([rgb * shade, hit[..., None].astype(np.float32)], -1)
    rgba[~hit] = 0.0
    return rgba.astype(np.float32)


def make_box_scene(
    n_train: int = 20,
    n_val: int = 4,
    n_test: int = 8,
    H: int = 64,
    W: int = 64,
    radius: float = 4.0,
    seed: int = 0,
    variant: int = 0,
) -> BlenderScene:
    """A BlenderScene with analytic ground-truth images (RGBA in [0,1])."""
    rng = np.random.default_rng(seed)
    camera_angle_x = 0.6911112070083618  # lego's fov
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    n_total = n_train + n_val + n_test
    thetas = rng.uniform(-180, 180, n_total)
    phis = rng.uniform(-60, -10, n_total)
    poses = np.stack(
        [pose_spherical(t, p, radius) for t, p in zip(thetas, phis)]
    ).astype(np.float32)

    scene = BlenderScene(
        images=np.zeros((n_total, H, W, 4), np.float32),
        poses=poses,
        render_poses=render_spiral_poses(40, -30.0, radius),
        H=H,
        W=W,
        focal=float(focal),
        i_split=[
            np.arange(0, n_train),
            np.arange(n_train, n_train + n_val),
            np.arange(n_train + n_val, n_total),
        ],
    )
    K = scene.K
    for i in range(n_total):
        o, d = get_rays_np(H, W, K, poses[i])
        rgba = _shade(o.reshape(-1, 3), d.reshape(-1, 3), variant)
        scene.images[i] = rgba.reshape(H, W, 4)
    return scene


def analytic_coord_map(
    pose: np.ndarray, H: int, W: int, K: np.ndarray, miss_t: float = 4.0,
) -> np.ndarray:
    """Exact per-pixel 3D surface coordinates [H, W, 3] for the box scene.
    Rays that miss the box get the point at t = miss_t."""
    o, d = get_rays_np(H, W, K, pose)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    t, hit = _ray_box(o, d)
    t = np.where(hit, t, miss_t)
    return (o + t[:, None] * d).reshape(H, W, 3).astype(np.float32)


def make_forward_scene(
    n_train: int = 12,
    n_val: int = 2,
    n_test: int = 4,
    H: int = 64,
    W: int = 64,
    radius: float = 4.0,
    seed: int = 0,
) -> BlenderScene:
    """Forward-facing variant of the box scene: every camera sits in a
    small angular cone looking at the box — the geometry class the LLFF
    NDC path (ndc_rays, run_nerf_helpers.py:179-196) targets. Returns RGB
    images (white-composited; real forward-facing photos have no alpha)."""
    rng = np.random.default_rng(seed)
    camera_angle_x = 0.6911112070083618
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )

    n_total = n_train + n_val + n_test
    thetas = rng.uniform(-12, 12, n_total)
    phis = rng.uniform(-14, -2, n_total)
    poses = np.stack(
        [pose_spherical(t, p, radius) for t, p in zip(thetas, phis)]
    ).astype(np.float32)

    images = np.zeros((n_total, H, W, 3), np.float32)
    for i in range(n_total):
        o, d = get_rays_np(H, W, K, poses[i])
        rgba = _shade(o.reshape(-1, 3), d.reshape(-1, 3)).reshape(H, W, 4)
        a = rgba[..., 3:4]
        images[i] = rgba[..., :3] * a + (1.0 - a)

    return BlenderScene(
        images=images,
        poses=poses,
        render_poses=poses[: min(8, n_total)].copy(),
        H=H,
        W=W,
        focal=float(focal),
        i_split=[
            np.arange(0, n_train),
            np.arange(n_train, n_train + n_val),
            np.arange(n_train + n_val, n_total),
        ],
    )


def write_llff_format(
    scene: BlenderScene, basedir: str,
    near: float = 3.0, far: float = 5.5,
) -> None:
    """Persist a forward-facing scene as images/ + poses_bounds.npy so
    `load_llff_data` (the poses_bounds grammar of load_llff.py:243-268)
    round-trips on it. Poses are stored in LLFF's [down right back]
    column convention with the hwf column appended."""
    imgdir = os.path.join(basedir, "images")
    os.makedirs(imgdir, exist_ok=True)
    n = scene.images.shape[0]
    rows = np.zeros((n, 17), np.float64)
    for i in range(n):
        img8 = (np.clip(scene.images[i][..., :3], 0, 1) * 255).astype(
            np.uint8
        )
        imwrite(os.path.join(imgdir, f"{i:03d}.png"), img8)
        c2w = scene.poses[i]
        # [right up back] → stored [down right back]
        stored = np.stack(
            [-c2w[:3, 1], c2w[:3, 0], c2w[:3, 2], c2w[:3, 3],
             np.array([scene.H, scene.W, scene.focal], np.float64)],
            axis=1,
        )
        rows[i, :15] = stored.reshape(-1)
        rows[i, 15:] = [near, far]
    np.save(os.path.join(basedir, "poses_bounds.npy"), rows)


def write_blender_format(scene: BlenderScene, basedir: str) -> None:
    """Persist a scene in the transforms_{split}.json + PNG on-disk layout
    so `load_blender_data` round-trips on it."""
    camera_angle_x = 2.0 * np.arctan(0.5 * scene.W / scene.focal)
    for split_i, split in enumerate(["train", "val", "test"]):
        subdir = os.path.join(basedir, split)
        os.makedirs(subdir, exist_ok=True)
        frames = []
        for j, i in enumerate(scene.i_split[split_i]):
            rel = f"./{split}/r_{j}"
            img8 = (np.clip(scene.images[i], 0, 1) * 255).astype(np.uint8)
            imwrite(os.path.join(basedir, rel + ".png"), img8)
            frames.append({"file_path": rel,
                           "transform_matrix": scene.poses[i].tolist()})
        with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as f:
            json.dump(
                {"camera_angle_x": float(camera_angle_x), "frames": frames}, f
            )
