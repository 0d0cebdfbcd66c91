"""Attack evaluation — the reference `test_for_inception` acceptance report
(model_test.py:41-421) as a function over arrays.

Given attacked and original images of the target class (plus, optionally,
the other classes' clean images), `evaluate_attack` reports the attack
success rate, clean and attacked accuracy on the target class, the
misclassification histogram and the perturbation budget stats. The
classifier runs on `device`; the statistics are numpy on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerfail_tpu_torch.eval.metrics import (
    attack_success_rate,
    misclassification_histogram,
    perturbation_stats,
)
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device


@torch.no_grad()
def predict_all(
    logits_fn: Callable, images: np.ndarray, batch_size: int = 16,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    dev = resolve_device(device)
    preds = []
    for s in range(0, images.shape[0], batch_size):
        x = torch.as_tensor(np.asarray(images[s:s + batch_size], np.float32),
                            device=dev)
        preds.append(torch.argmax(logits_fn(x), dim=-1).cpu().numpy())
    return np.concatenate(preds) if preds else np.zeros((0,), np.int64)


def evaluate_attack(
    logits_fn: Callable,
    attacked_images: np.ndarray,     # [N, S, S, 3] white-composited 0-255
    original_images: np.ndarray,     # [N, S, S, 3]
    true_label: int,
    other_images: Optional[np.ndarray] = None,   # clean imgs, other classes
    other_labels: Optional[np.ndarray] = None,
    num_classes: int = 8,
    batch_size: int = 16,
    device: DeviceLike = "cuda",
) -> Dict:
    preds_att = predict_all(logits_fn, attacked_images, batch_size, device)
    preds_ori = predict_all(logits_fn, original_images, batch_size, device)

    out: Dict = {
        "asr": attack_success_rate(preds_att, true_label),
        "clean_acc_target_class": float(np.mean(preds_ori == true_label)),
        "attacked_acc_target_class": float(np.mean(preds_att == true_label)),
        "misclass_histogram": misclassification_histogram(
            preds_att, num_classes
        ).tolist(),
        **perturbation_stats(attacked_images, original_images),
    }
    if other_images is not None and other_labels is not None:
        preds_other = predict_all(logits_fn, other_images, batch_size, device)
        out["other_class_acc"] = float(np.mean(preds_other == other_labels))
    return out
