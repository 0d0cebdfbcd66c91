"""Attack evaluation — the reference `test_for_inception` acceptance report
(model_test.py:41-421) as a function over arrays.

Given attacked and original images of the target class (plus, optionally,
the other classes' clean images), `evaluate_attack` reports the attack
success rate, clean and attacked accuracy on the target class, the
misclassification histogram and the perturbation budget stats.
`evaluate_testset` is the full report over a labelled test set: overall
and per-class loss and accuracy, and for the attacked class its ASR, the
misclassification table and the perturbation stats, and optionally the
annotated images (`annotate_predictions`). The classifier runs on
`device`; the statistics are numpy on the host.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from nerfail_tpu_torch.config import SCENE_CLASSES
from nerfail_tpu_torch.eval.metrics import (
    attack_success_rate,
    misclassification_histogram,
    perturbation_stats,
)
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device
from nerfail_tpu_torch.utils.font import put_text
from nerfail_tpu_torch.utils.png import imwrite

# the class colours of the annotated dump (RGB), as the JAX package's
ANNOTATE_COLORS = (
    (230, 60, 60), (60, 180, 60), (60, 60, 230), (200, 180, 40),
    (180, 60, 200), (40, 190, 190), (130, 130, 130), (250, 140, 20),
)


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


def annotation_text(logits: np.ndarray,
                    class_names: Sequence[str] = SCENE_CLASSES):
    """(predicted class, "class: p%" label) of each row of [N, C] logits,
    p the softmax confidence in percent to two decimals."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    preds = np.argmax(logits, axis=-1)
    return [(int(c), f"{class_names[c]}: {100.0 * probs[j, c]:.2f}%")
            for j, c in enumerate(preds)]


def annotate_predictions(
    images: np.ndarray,          # [N, S, S, 3] 0-255 (originals to annotate)
    logits: np.ndarray,          # [N, C]
    out_dir: str,
    indices: Optional[np.ndarray] = None,
    class_names: Sequence[str] = SCENE_CLASSES,
) -> None:
    """Write r_<i>.png with the predicted class and its softmax confidence
    drawn on (model_test.py:310-319's annotated dump), i = indices[j] or
    j. The text, its origin (W // 8, H // 8, the baseline's left end), its
    scale max(H / 800, 0.3) and the class colours are the JAX package's;
    the glyphs come from utils/font.py's 5×7 bitmap font, not cv2's
    Hershey triplex, so the pixels of the text differ from cv2's."""
    os.makedirs(out_dir, exist_ok=True)
    n = images.shape[0]
    idxs = indices if indices is not None else np.arange(n)
    for j, (pred, text) in enumerate(annotation_text(logits, class_names)):
        img = np.ascontiguousarray(
            np.clip(images[j], 0, 255).astype(np.uint8))
        put_text(img, text, (img.shape[1] // 8, img.shape[0] // 8),
                 max(img.shape[0] / 800.0, 0.3),
                 ANNOTATE_COLORS[pred % len(ANNOTATE_COLORS)])
        imwrite(os.path.join(out_dir, f"r_{int(idxs[j])}.png"), img)


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
    annotate_images: Optional[np.ndarray] = None,
    indices: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """The reference's full `test_for_inception` report
    (model_test.py:41-421): overall and per-class loss and accuracy, and
    for the attacked class the ASR, the misclassification histogram, the
    "ground truth X, now Y — Z %" table (`misclass_to_pct`) and the
    perturbation stats against the originals. With `annotate_dir`, the
    attacked class's images (or `annotate_images`) are written there with
    their predictions drawn on (`annotate_predictions`, named by
    `indices` of those rows)."""
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
        if annotate_dir is not None:
            ann = annotate_images if annotate_images is not None else images[m]
            annotate_predictions(
                ann, logits[m], annotate_dir,
                indices=None if indices is None else np.asarray(indices)[m])
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
