"""Attack evaluation — the reference `test_for_inception` acceptance report
(model_test.py:41-421) as a function over arrays.

Given attacked and original images of the target class (plus, optionally,
the other classes' clean images), `evaluate_attack` reports the attack
success rate, clean and attacked accuracy on the target class, the
misclassification histogram and the perturbation budget stats.
`evaluate_testset` is the full report over a labelled test set: overall
and per-class loss and accuracy, and for the attacked class its ASR, the
misclassification table and the perturbation stats. The classifier runs
on `device`; the statistics are numpy on the host.
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


@torch.no_grad()
def logits_all(
    logits_fn: Callable, images: np.ndarray, batch_size: int = 16,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """[N, C] float32 logits of `images`, in batches on `device`."""
    dev = resolve_device(device)
    out = []
    for s in range(0, images.shape[0], batch_size):
        x = torch.as_tensor(np.asarray(images[s:s + batch_size], np.float32),
                            device=dev)
        out.append(logits_fn(x).float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


def _ce_loss(logits: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-sample softmax cross-entropy (the reference's criterion)."""
    m = logits.max(axis=-1, keepdims=True)
    lse = m[..., 0] + np.log(np.exp(logits - m).sum(axis=-1))
    return lse - logits[np.arange(len(labels)), labels]


def evaluate_testset(
    logits_fn: Callable,
    images: np.ndarray,          # [N, S, S, 3] 0-255, every class's images
    labels: np.ndarray,          # [N] true class of each image
    attacked_class: Optional[int] = None,
    original_images: Optional[np.ndarray] = None,  # originals of the
                                                   # attacked class's rows
    num_classes: int = 8,
    batch_size: int = 16,
    annotate_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """The reference's full `test_for_inception` report
    (model_test.py:41-421): overall and per-class loss and accuracy, and
    for the attacked class the ASR, the misclassification histogram, the
    "ground truth X, now Y — Z %" table (`misclass_to_pct`) and the
    perturbation stats against the originals.

    The annotated-image dump (`annotate_dir`) needs cv2 and imageio, which
    the port does not depend on; it raises until the orchestration slice
    (ROADMAP Queue 1, the orchestration item) ports it."""
    if annotate_dir is not None:
        raise NotImplementedError(
            "annotate_predictions is not ported yet (ROADMAP Queue 1, "
            "orchestration: annotate_predictions)")
    logits = logits_all(logits_fn, images, batch_size, device)
    labels = np.asarray(labels)
    preds = np.argmax(logits, axis=-1)
    losses = _ce_loss(logits, labels)

    per_class = {}
    for c in range(num_classes):
        m = labels == c
        if not m.any():
            continue
        per_class[str(c)] = {
            "loss": float(losses[m].mean()),
            "acc": float((preds[m] == c).mean()),
            "n": int(m.sum()),
        }
    out: Dict = {
        "overall_loss": float(losses.mean()) if len(losses) else 0.0,
        "overall_acc": float((preds == labels).mean()) if len(preds) else 0.0,
        "per_class": per_class,
    }
    if attacked_class is not None:
        m = labels == attacked_class
        preds_att = preds[m]
        out["asr"] = attack_success_rate(preds_att, attacked_class)
        out["misclass_histogram"] = misclassification_histogram(
            preds_att, num_classes).tolist()
        n_att = max(len(preds_att), 1)
        out["misclass_to_pct"] = {
            str(k): 100.0 * float((preds_att == k).sum()) / n_att
            for k in np.unique(preds_att)
        }
        if original_images is not None:
            out.update(perturbation_stats(images[m], original_images))
    return out


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
