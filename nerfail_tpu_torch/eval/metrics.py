"""Attack-quality metrics.

Parity with the reference harness (model_test.py:26-39 get_psnr,
:256-278 perturbation stats, :359-377 ASR):

  e_min/e_avg/e_max : per-image L∞ of (attacked − original), min/avg/max
                      over the set (0-255 scale)
  L2                : mean per-image L2 norm of the perturbation
  L0                : mean fraction of changed pixels
  PSNR              : 10·log10(255² / MSE) per image, min/avg/max
  ASR               : 1 − fraction still classified as the true class
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def psnr_255(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 ** 2 / mse)


def perturbation_stats(
    attacked: np.ndarray,     # [N, H, W, C] 0-255
    originals: np.ndarray,    # [N, H, W, C] 0-255
) -> Dict[str, float]:
    diff = attacked.astype(np.float64) - originals.astype(np.float64)
    n = diff.shape[0]
    linf = np.max(np.abs(diff).reshape(n, -1), axis=1)
    l2 = np.linalg.norm(diff.reshape(n, -1), axis=1)
    l0 = np.mean((np.abs(diff) > 0).reshape(n, -1), axis=1)
    psnrs = np.array([psnr_255(attacked[i], originals[i]) for i in range(n)])
    return {
        "e_min": float(linf.min()),
        "e_avg": float(linf.mean()),
        "e_max": float(linf.max()),
        "l2_avg": float(l2.mean()),
        "l0_avg": float(l0.mean()),
        "psnr_min": float(psnrs.min()),
        "psnr_avg": float(psnrs.mean()),
        "psnr_max": float(psnrs.max()),
    }


def attack_success_rate(preds: np.ndarray, true_label: int) -> float:
    """1 − fraction still classified as the true class (model_test.py:359-377)."""
    return float(1.0 - np.mean(preds == true_label))


def misclassification_histogram(
    preds: np.ndarray, num_classes: int = 8
) -> np.ndarray:
    return np.bincount(preds, minlength=num_classes)
