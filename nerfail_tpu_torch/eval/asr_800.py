"""The attack's own classifier at 800²: Inception-V3 trained on the box
classes through the attack's preprocessing, in the port.

Ports tools/full_rehearsal.py:188-275 (`_render_class_views`,
`train_rehearsal_classifier`), the trained Inception of the JAX package's
800² ASR run (tools/asr_demo.py): the 8 box classes rendered at 800²
from random poses by `data/synthetic._shade` and white-composited, 24
train and 4 validation views per class (pose seeds 100 + c and 900 + c),
resized to 299² by the attack's own antialiased resize matrices
(`attacks/forward.resize_batch`, not `F.interpolate`), so the frozen
classifier sees what the attack forward feeds it. Inception-V3 with its
auxiliary head is then trained by `train/classifier_trainer` with Adam
3e-4, batch 16, for 40 epochs, and the weights of the best validation
epoch are kept. No weights are stored: every run trains them anew.
`attack_scene` and `attack_views` give the attacked scene (class 0) as
the JAX tool's `_scene` and `build_tables` pose and render it.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerfail_tpu_torch.attacks.forward import resize_batch
from nerfail_tpu_torch.data.poses import pose_spherical
from nerfail_tpu_torch.data.synthetic import _shade, analytic_coord_map
from nerfail_tpu_torch.models.classifiers.inception_v3 import InceptionV3
from nerfail_tpu_torch.ops.rays import get_rays_np
from nerfail_tpu_torch.train.classifier_trainer import train_classifier
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

H = 800
RESIZE = 299
N_CLASSES = 8
N_TRAIN, N_VAL = 24, 4
CAMERA_ANGLE_X = 0.6911112070083618
WORKERS = 4                    # host threads that shade the class views


def render_class_views(variant: int, n: int, size: int,
                       seed: int) -> np.ndarray:
    """White-composited 0-255 RGB renders [n, size, size, 3] of box class
    `variant` from the n poses of attack_scene(n, size, seed), as the
    JAX package's `_render_class_views`. The views are shaded on
    WORKERS host threads; each is bit-equal to a serial render."""
    K, poses = attack_scene(n, size, seed)

    def one(pose):
        o, d = get_rays_np(size, size, K, pose)
        rgba = _shade(o.reshape(-1, 3), d.reshape(-1, 3), variant)
        rgba = rgba.reshape(size, size, 4)
        return np.where(rgba[..., 3:] > 0, rgba[..., :3] * 255.0, 255.0)

    out = np.empty((n, size, size, 3), np.float32)
    with ThreadPoolExecutor(max_workers=WORKERS) as ex:
        for i, img in enumerate(ex.map(one, poses)):
            out[i] = img
    return out


def class_data(size: int = H, resize: int = RESIZE, n_train: int = N_TRAIN,
               n_val: int = N_VAL,
               device: DeviceLike = "cuda") -> Dict[str, np.ndarray]:
    """The 8 classes' train and validation images at `resize`², through
    resize_batch on `device` in slices of 4 views."""
    dev = resolve_device(device)

    def prep(variant, n, seed):
        full = render_class_views(variant, n, size, seed)
        with torch.no_grad():
            return np.concatenate([
                resize_batch(torch.from_numpy(full[s:s + 4]).to(dev),
                             resize).cpu().numpy()
                for s in range(0, n, 4)])

    tr = [prep(c, n_train, 100 + c) for c in range(N_CLASSES)]
    va = [prep(c, n_val, 900 + c) for c in range(N_CLASSES)]
    return {
        "tr_x": np.concatenate(tr),
        "tr_y": np.repeat(np.arange(N_CLASSES), n_train),
        "va_x": np.concatenate(va),
        "va_y": np.repeat(np.arange(N_CLASSES), n_val),
    }


def train_inception(
    data: Dict[str, np.ndarray], device: DeviceLike = "cuda",
    epochs: int = 40, log_fn: Optional[Callable] = None,
) -> Tuple[InceptionV3, Dict]:
    """Inception-V3 (auxiliary head on) from torch.manual_seed(0), trained
    on `data` with Adam 3e-4, batch 16; returns the model with the weights of its best
    validation epoch (the first of equals) and a summary: best val_acc,
    its epoch, wall seconds and the per-epoch log."""
    dev = resolve_device(device)
    torch.manual_seed(0)
    model = InceptionV3(num_classes=N_CLASSES, aux_logits=True)
    hist, best = [], {"val_acc": -1.0}

    def keep_best(epoch, m):
        hist.append(m)
        if m["val_acc"] > best["val_acc"]:
            best.update(val_acc=m["val_acc"], epoch=epoch, state={
                k: v.detach().clone() for k, v in model.state_dict().items()})
        if log_fn:
            log_fn(epoch, m)

    t0 = time.time()
    train_classifier(
        model, data["tr_x"], data["tr_y"], data["va_x"], data["va_y"],
        epochs=epochs, batch_size=16, log_fn=keep_best,
        optimizer=lambda p: torch.optim.Adam(p, lr=3e-4), device=dev)
    model.load_state_dict(best.pop("state"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return model.eval(), {"val_acc": best["val_acc"],
                          "best_epoch": best["epoch"],
                          "train_s": time.time() - t0, "epochs": epochs,
                          "history": hist}


def attack_scene(n_views: int, size: int = H, seed: int = 0):
    """Intrinsics and n_views poses at radius 4, angles drawn by
    np.random.default_rng(seed), as the JAX tool's `_scene` (seed 0: the
    attacked scene) and `_render_class_views` (a class's seed)."""
    rng = np.random.default_rng(seed)
    focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                 np.float32)
    thetas = rng.uniform(-180, 180, n_views)
    phis = rng.uniform(-60, -10, n_views)
    poses = np.stack([pose_spherical(t, p, 4.0)
                      for t, p in zip(thetas, phis)]).astype(np.float32)
    return K, poses


def attack_views(K: np.ndarray, poses: np.ndarray, size: int = H,
                 mask_views=(0, 1, 2)):
    """uint8 RGBA renders [N, size, size, 4] of the attacked scene and the
    point set S [len(mask_views)·size², 3]: the analytic surface points
    of the mask views."""
    ori = np.empty((len(poses), size, size, 4), np.uint8)
    for v, pose in enumerate(poses):
        o, d = get_rays_np(size, size, K, pose)
        rgba = _shade(o.reshape(-1, 3), d.reshape(-1, 3))
        ori[v] = np.clip(rgba * 255.0, 0, 255).astype(np.uint8).reshape(
            size, size, 4)
    S = np.concatenate([analytic_coord_map(poses[v], size, size, K)
                        .reshape(-1, 3) for v in mask_views])
    return ori, S
