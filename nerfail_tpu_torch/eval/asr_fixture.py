"""The 64² trained-classifier ASR fixture, in the port.

The port's counterpart of tests/test_asr.py:44-138: SimpleCNN trained on
8 procedural box-scene classes (12 train and 3 validation views each),
then class 0's 12 train views as attack targets, with a point set from 6
mask views on the analytic surface and 8-NN tables from it. It isolates
the attack path from NeRF fitting, as the JAX test does, and gives the
port an attack result on a trained classifier on the CPU (slow tests);
the attacks' card paths are held to their CPU paths by
tests/test_torch_gpu.py. It is a 64² / SimpleCNN fixture, not the
paper's 800² / Inception-V3 setting.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from nerfail_tpu_torch.attacks.forward import (
    splat_attack_forward, white_composite_255, zero_init_mask,
)
from nerfail_tpu_torch.config import AttackConfig
from nerfail_tpu_torch.data.synthetic import (
    BlenderScene, analytic_coord_map, make_box_scene,
)
from nerfail_tpu_torch.eval.harness import evaluate_attack
from nerfail_tpu_torch.models.classifiers.simple_cnn import SimpleCNN
from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
from nerfail_tpu_torch.pointset.weights import gauss_weights
from nerfail_tpu_torch.train.classifier_trainer import train_classifier
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

H = W = 64
N_CLASSES = 8
N_TRAIN_VIEWS = 12
N_VAL_VIEWS = 3
MASK_VIEWS = (0, 2, 4, 6, 8, 10)       # p = 6 base mask images

# the acceptance configurations of tests/test_asr.py:144 and :164-165
NERFAIL_S_CFG = AttackConfig(eps=64.0, a=4.0, batch_size=6,
                             attack_epochs=60)
NERFAIL_CFG = AttackConfig(eps=64.0, m1=2.0, m2=10.0, df_max_iter=100,
                           view_batch=6, attack_epochs=20)


def white255(images: np.ndarray) -> np.ndarray:
    """RGBA [*,H,W,4] in [0,1] → white-composited RGB 0-255."""
    rgb = images[..., :3] * 255.0
    return np.where(images[..., 3:] > 0, rgb, 255.0).astype(np.float32)


def box_classes() -> Tuple[List[BlenderScene], Dict[str, np.ndarray]]:
    """The 8 class scenes and their train / validation images."""
    scenes = [make_box_scene(n_train=N_TRAIN_VIEWS, n_val=N_VAL_VIEWS,
                             n_test=0, H=H, W=W, seed=100 + c, variant=c)
              for c in range(N_CLASSES)]
    data = {
        "tr_x": np.concatenate([white255(s.images[s.i_split[0]])
                                for s in scenes]),
        "tr_y": np.repeat(np.arange(N_CLASSES), N_TRAIN_VIEWS),
        "va_x": np.concatenate([white255(s.images[s.i_split[1]])
                                for s in scenes]),
        "va_y": np.repeat(np.arange(N_CLASSES), N_VAL_VIEWS),
    }
    return scenes, data


def train_box_classifier(data: Dict[str, np.ndarray], device: DeviceLike,
                         seed: int = 0) -> Tuple[SimpleCNN, List[Dict]]:
    """SimpleCNN trained with Adam(1e-3), 40 epochs, batch 16, as the JAX
    fixture; returns the model and its per-epoch log."""
    torch.manual_seed(seed)
    model = SimpleCNN(num_classes=N_CLASSES)
    hist: List[Dict] = []
    train_classifier(
        model, data["tr_x"], data["tr_y"], data["va_x"], data["va_y"],
        epochs=40, batch_size=16, seed=seed, device=device,
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-3),
        log_fn=lambda e, m: hist.append(m),
    )
    return model, hist


def attack_tables(target: BlenderScene, device: DeviceLike) -> Dict:
    """Class 0's attack inputs: tables [12, 64, 64, 8] on `device`, clean
    RGBA 0-255, the zero-init mask stack δ0, and the clean white images."""
    dev = resolve_device(device)
    S = np.concatenate([
        analytic_coord_map(target.poses[v], H, W, target.K).reshape(-1, 3)
        for v in MASK_VIEWS])
    # c scales with the pixel surface footprint (reference c=0.02 at 800²)
    c = 0.02 * 800.0 / H
    wts, idxs = [], []
    for v in range(N_TRAIN_VIEWS):
        cm = analytic_coord_map(target.poses[v], H, W, target.K)
        d, i = build_index_and_dist(cm, S, device=dev)
        wts.append(gauss_weights(d, c=c))
        idxs.append(i)
    views = target.images[:N_TRAIN_VIEWS]
    ori = np.concatenate([views[..., :3] * 255.0, views[..., 3:] * 255.0],
                         -1).astype(np.float32)
    return {
        "wts": torch.stack(wts), "idxs": torch.stack(idxs), "ori": ori,
        "delta0": zero_init_mask(ori[list(MASK_VIEWS)]).numpy(),
        "clean": white255(views), "labels": np.zeros(N_TRAIN_VIEWS, np.int64),
    }


@torch.no_grad()
def acceptance(logits_fn: Callable, tables: Dict, delta: np.ndarray,
               eps: float, device: DeviceLike) -> Dict:
    """The reference acceptance report (model_test.py:359-377) for the
    attacked views under δ."""
    out = splat_attack_forward(
        np.asarray(delta).reshape(-1, 4), tables["wts"], tables["idxs"],
        tables["ori"], logits_fn, eps=eps, resize_to=None, device=device)
    rgba = out["attacked_rgba"]
    attacked = white_composite_255(rgba[..., :3], rgba[..., 3:])
    return evaluate_attack(logits_fn, attacked.cpu().numpy(),
                           tables["clean"], true_label=0,
                           num_classes=N_CLASSES, device=device)
