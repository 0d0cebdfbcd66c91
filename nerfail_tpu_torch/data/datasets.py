"""Classifier/attack dataset utilities — the reference MyDataset.py family.

Ports nerfail_tpu/data/datasets.py. Parity semantics:
  - class-folder scan: data/<class>/{train,val,test} of r_<i>.png renders,
    class index = position in SCENE_CLASSES (MySimpleDataset,
    MyDataset.py:28-184)
  - RGBA→RGB on white: rgb where alpha>0 else 255 (MyDataset.py:102-105)
  - 0-255 float pixel scale throughout (no normalization)
  - `override_dir` replaces ONE class's images with an attacked set while
    `ori_dir` provides the clean originals for perturbation stats
    (test_dir_change_dict / ori_img_from, model_test.py:66)
  - filename-index parsing `r_<i>.png` / `NNN.png`

Images are read by utils/png and resized by the attack's bilinear
matrices (attacks/forward._resize_weights: jax.image.resize's
antialiased bilinear kernel), so a dataset resized here equals the JAX
package's. Everything returns contiguous numpy arrays.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from nerfail_tpu_torch.attacks.forward import _resize_weights
from nerfail_tpu_torch.config import SCENE_CLASSES
from nerfail_tpu_torch.utils.png import imread

# both the attack outputs (r_<i>.png) and the NeRF renders (NNN.png) —
# the reference parses both forms (MyDataset.py:82-86)
_IDX_RE = re.compile(r"^(?:r_)?(\d+)\.(?:png|jpg|jpeg)$")


def _imread(path: str) -> np.ndarray:
    return imread(path).astype(np.float32)


def rgba_to_white_rgb(img: np.ndarray) -> np.ndarray:
    """[..., 4] 0-255 → [..., 3]: rgb where alpha>0 else 255."""
    if img.shape[-1] == 3:
        return img
    rgb, alpha = img[..., :3], img[..., 3:4]
    return np.where(alpha > 0, rgb, 255.0)


def resize_image(img: np.ndarray, size: Optional[int]) -> np.ndarray:
    """Bilinear resize of [H, W, C] to size² (host-side, for static
    datasets), jax.image.resize's "bilinear" numerics."""
    if size is None or img.shape[0] == size:
        return img
    A_h = _resize_weights(img.shape[0], size)
    A_w = _resize_weights(img.shape[1], size)
    x = np.asarray(img, np.float32)
    y = np.einsum("ow,hwc->hoc", A_w, x)
    return np.einsum("oh,hwc->owc", A_h, y).astype(np.float32)


def list_split_images(class_dir: str, split: str) -> List[Tuple[int, str]]:
    """[(frame_index, path)] sorted by frame index for data/<class>/<split>."""
    d = os.path.join(class_dir, split)
    out = []
    if not os.path.isdir(d):
        return out
    for name in os.listdir(d):
        m = _IDX_RE.search(name)
        if m:
            out.append((int(m.group(1)), os.path.join(d, name)))
    out.sort()
    return out


@dataclass
class ClassifierDataset:
    images: np.ndarray    # [N, S, S, 3] 0-255 float
    labels: np.ndarray    # [N] int
    indices: np.ndarray   # [N] frame index within its class/split
    ori_images: Optional[np.ndarray] = None   # originals for overridden class


def load_classifier_split(
    root: str,
    split: str,
    size: Optional[int],
    classes: Sequence[str] = SCENE_CLASSES,
    override_dir: Optional[str] = None,
    override_class: Optional[str] = None,
    ori_dir: Optional[str] = None,
) -> ClassifierDataset:
    """Scan data/<class>/<split> folders into one array dataset.

    override_dir/override_class implement test_dir_change_dict: that class's
    images come from the attacked output dir instead; ori_dir supplies the
    matching clean originals (for e/L2/L0/PSNR stats).
    """
    imgs, labels, idxs, oris = [], [], [], []
    for ci, cls in enumerate(classes):
        if override_class == cls and override_dir is not None:
            entries = []
            for name in os.listdir(override_dir):
                m = _IDX_RE.search(name)
                if m and not name.endswith("_ori.png") and "mask" not in name:
                    entries.append((int(m.group(1)),
                                    os.path.join(override_dir, name)))
            entries.sort()
        else:
            entries = list_split_images(os.path.join(root, cls), split)
        for frame_i, path in entries:
            imgs.append(resize_image(rgba_to_white_rgb(_imread(path)), size))
            labels.append(ci)
            idxs.append(frame_i)
            if override_class == cls and ori_dir is not None:
                ori = _imread(os.path.join(ori_dir, f"r_{frame_i}.png"))
                oris.append(resize_image(rgba_to_white_rgb(ori), size))
    return ClassifierDataset(
        images=np.stack(imgs).astype(np.float32),
        labels=np.asarray(labels, np.int64),
        indices=np.asarray(idxs, np.int64),
        ori_images=np.stack(oris).astype(np.float32) if oris else None,
    )


def scene_views_dataset(
    images: np.ndarray,            # [N, H, W, 4] floats in [0,1] (scene loader)
) -> np.ndarray:
    """Scene RGBA [0,1] → attack-space RGBA [0,255] float (the gauss_dataset
    convention: raw uint8-scale RGBA, MyDataset.py:187-232)."""
    return np.clip(images * 255.0, 0.0, 255.0).astype(np.float32)
