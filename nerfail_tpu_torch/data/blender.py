"""Blender synthetic-scene loader (transforms_*.json + RGBA PNGs).

Ports nerfail_tpu/data/blender.py, the reference's `load_blender_data`
(load_blender.py:37-110):
  - reads transforms_{train,val,test}.json under `basedir`
  - images as float32 RGBA in [0, 1] (PNG /255), read by utils/png
  - `testskip` subsamples val/test splits (train always dense)
  - `half_res` downscales H, W, focal by 2 (2×2 box filter)
  - focal = 0.5·W / tan(0.5·camera_angle_x)
  - `train_dir` swaps the *train* images for an attacked set while keeping
    the originals available (the perturbation-inheritance entry point,
    load_blender.py:62-63,107-108)
  - a 40-pose spiral is returned for video rendering

Host numpy, as in the JAX package, so both load bit-equal arrays.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from nerfail_tpu_torch.data.poses import render_spiral_poses
from nerfail_tpu_torch.utils.png import imread


def _area_downscale2(img: np.ndarray) -> np.ndarray:
    """2× box-filter downscale (cv2.INTER_AREA equivalent for factor 2)."""
    H, W = img.shape[:2]
    return img.reshape(H // 2, 2, W // 2, 2, -1).mean(axis=(1, 3))


@dataclass
class BlenderScene:
    """Images, poses and intrinsics of one scene (load_blender.py:37-110)."""

    images: np.ndarray          # [N, H, W, 4] float32 in [0,1]
    poses: np.ndarray           # [N, 4, 4]
    render_poses: np.ndarray    # [40, 4, 4] spiral
    H: int
    W: int
    focal: float
    i_split: List[np.ndarray] = field(default_factory=list)  # train/val/test
    # original (non-attacked) train images when train_dir swapped them in
    images_ori: Optional[np.ndarray] = None
    # explicit intrinsics (LINEMOD frames carry their own K,
    # load_LINEMOD.py:37-95); None → derived from focal
    K_explicit: Optional[np.ndarray] = None

    @property
    def K(self) -> np.ndarray:
        if self.K_explicit is not None:
            return self.K_explicit
        return np.array(
            [
                [self.focal, 0, 0.5 * self.W],
                [0, self.focal, 0.5 * self.H],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )

    @property
    def i_train(self) -> np.ndarray:
        return self.i_split[0]

    @property
    def i_val(self) -> np.ndarray:
        return self.i_split[1]

    @property
    def i_test(self) -> np.ndarray:
        return self.i_split[2]


def load_blender_data(
    basedir: str,
    half_res: bool = False,
    testskip: int = 1,
    train_dir: Optional[str] = None,
) -> BlenderScene:
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            metas[s] = json.load(f)

    all_imgs, all_poses, counts = [], [], [0]
    ori_train_imgs = None
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        frames = meta["frames"][::skip]
        imgs = np.stack(
            [imread(os.path.join(basedir, fr["file_path"] + ".png"))
             for fr in frames]
        ).astype(np.float32) / 255.0
        poses = np.stack(
            [np.array(fr["transform_matrix"], np.float32) for fr in frames]
        )
        if s == "train" and train_dir is not None:
            # perturbation inheritance: train on attacked renders but keep
            # the originals (load_blender.py:62-63,107-108)
            ori_train_imgs = imgs
            imgs = np.stack(
                [imread(os.path.join(train_dir, f"r_{i}.png"))
                 for i in range(len(frames))]
            ).astype(np.float32) / 255.0
            if imgs.shape[-1] == 3:  # attacked sets may be RGB
                imgs = np.concatenate([imgs, ori_train_imgs[..., 3:4]],
                                      axis=-1)
        all_imgs.append(imgs)
        all_poses.append(poses)
        counts.append(counts[-1] + imgs.shape[0])

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, axis=0)
    poses = np.concatenate(all_poses, axis=0)

    H, W = imgs.shape[1:3]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack([_area_downscale2(im) for im in imgs]).astype(np.float32)
        if ori_train_imgs is not None:
            ori_train_imgs = np.stack(
                [_area_downscale2(im) for im in ori_train_imgs]
            ).astype(np.float32)

    return BlenderScene(
        images=imgs,
        poses=poses,
        render_poses=render_spiral_poses(40, -30.0, 4.0),
        H=int(H),
        W=int(W),
        focal=float(focal),
        i_split=i_split,
        images_ori=ori_train_imgs,
    )


def white_background_composite(images: np.ndarray) -> np.ndarray:
    """RGBA [.., 4] in [0,1] → RGB on white: rgb·a + (1-a) (run_nerf.py:578).
    RGB inputs (LLFF/DeepVoxels, no alpha) pass through unchanged."""
    if images.shape[-1] == 3:
        return images
    return images[..., :3] * images[..., 3:4] + (1.0 - images[..., 3:4])
