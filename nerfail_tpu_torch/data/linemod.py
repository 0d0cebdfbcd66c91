"""LINEMOD scene loader (capability parity with load_LINEMOD.py:37-95).

A copy of nerfail_tpu/data/linemod.py that reads images by utils/png.

Like the blender format but each frame carries its own intrinsic matrix
and the JSON supplies per-scene near/far planes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from nerfail_tpu_torch.utils.png import imread


def _imread(path: str) -> np.ndarray:
    return imread(path).astype(np.float32) / 255.0


@dataclass
class LinemodScene:
    images: np.ndarray
    poses: np.ndarray
    render_poses: np.ndarray
    H: int
    W: int
    K: np.ndarray
    near: float
    far: float
    i_split: List[np.ndarray]


def load_LINEMOD_data(
    basedir: str, half_res: bool = False, testskip: int = 1
) -> LinemodScene:
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            metas[s] = json.load(f)

    all_imgs, all_poses, counts = [], [], [0]
    K = None
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        frames = meta["frames"][::skip]
        imgs, poses = [], []
        for fr in frames:
            imgs.append(_imread(os.path.join(basedir, fr["file_path"])))
            poses.append(np.array(fr["transform_matrix"], np.float32))
            if K is None and "intrinsic_matrix" in fr:
                K = np.array(fr["intrinsic_matrix"], np.float32)
        all_imgs.append(np.stack(imgs))
        all_poses.append(np.stack(poses))
        counts.append(counts[-1] + len(frames))

    imgs = np.concatenate(all_imgs)
    poses = np.concatenate(all_poses)
    H, W = imgs.shape[1:3]
    near = float(metas["train"].get("near", 2.0))
    far = float(metas["train"].get("far", 6.0))
    if K is None:
        focal = 0.5 * W / np.tan(0.5 * float(metas["train"]["camera_angle_x"]))
        K = np.array(
            [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
        )
    if half_res:
        H, W = H // 2, W // 2
        K = K.copy()
        K[:2] /= 2.0
        imgs = imgs.reshape(
            imgs.shape[0], H, 2, W, 2, -1
        ).mean(axis=(2, 4)).astype(np.float32)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    from nerfail_tpu_torch.data.poses import render_spiral_poses

    return LinemodScene(
        images=imgs.astype(np.float32), poses=poses,
        render_poses=render_spiral_poses(40, -30.0, 4.0),
        H=int(H), W=int(W), K=K, near=near, far=far, i_split=i_split,
    )
