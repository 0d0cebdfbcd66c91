"""DeepVoxels scene loader (capability parity with load_deepvoxels.py:6-110).

A copy of nerfail_tpu/data/deepvoxels.py that reads images by utils/png.

Layout: <basedir>/<mode>/<scene>/ with intrinsics.txt, pose/*.txt
(flattened 4×4 row-major), rgb/*.png. Splits live in sibling dirs
train/validation/test.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from nerfail_tpu_torch.utils.png import imread


def _imread(path: str) -> np.ndarray:
    return imread(path).astype(np.float32) / 255.0


def load_pose(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32).reshape(4, 4)


def parse_intrinsics(path: str, H: int, W: int):
    with open(path) as f:
        lines = f.readlines()
    vals = lines[0].split()
    focal, cx, cy = float(vals[0]), float(vals[1]), float(vals[2])
    near_plane = float(lines[1].split()[0]) if len(lines) > 1 else 0.0
    scale = float(lines[2].split()[0]) if len(lines) > 2 else 1.0
    height_orig = float(lines[3].split()[0]) if len(lines) > 3 else H
    focal = focal * H / height_orig
    return focal, near_plane, scale


@dataclass
class DeepVoxelsScene:
    images: np.ndarray
    poses: np.ndarray
    render_poses: np.ndarray
    H: int
    W: int
    focal: float
    i_split: List[np.ndarray]


def load_dv_data(
    scene: str = "cube", basedir: str = "./data/deepvoxels", testskip: int = 8
) -> DeepVoxelsScene:
    def load_split(mode: str, skip: int):
        d = os.path.join(basedir, mode, scene)
        rgb_dir = os.path.join(d, "rgb")
        pose_dir = os.path.join(d, "pose")
        names = sorted(os.listdir(rgb_dir))[::skip]
        imgs = np.stack([_imread(os.path.join(rgb_dir, n))[..., :3] for n in names])
        poses = np.stack(
            [load_pose(os.path.join(pose_dir, n.replace(".png", ".txt")))
             for n in names]
        )
        return imgs, poses

    splits = [("train", 1), ("validation", testskip), ("test", testskip)]
    all_imgs, all_poses, counts = [], [], [0]
    for mode, skip in splits:
        imgs, poses = load_split(mode, skip)
        all_imgs.append(imgs)
        all_poses.append(poses)
        counts.append(counts[-1] + imgs.shape[0])

    imgs = np.concatenate(all_imgs)
    poses = np.concatenate(all_poses).astype(np.float32)
    H, W = imgs.shape[1:3]
    focal, _, _ = parse_intrinsics(
        os.path.join(basedir, "train", scene, "intrinsics.txt"), H, W
    )
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    # render path: circle at the mean camera radius
    radius = float(np.mean(np.linalg.norm(poses[:, :3, 3], axis=-1)))
    from nerfail_tpu_torch.data.poses import render_spiral_poses

    render_poses = render_spiral_poses(40, -30.0, radius)
    return DeepVoxelsScene(
        images=imgs.astype(np.float32), poses=poses,
        render_poses=render_poses, H=int(H), W=int(W), focal=float(focal),
        i_split=i_split,
    )
