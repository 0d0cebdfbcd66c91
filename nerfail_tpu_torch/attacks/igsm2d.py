"""IGSM-2D baseline: per-view 2D sign-step perturbations.

Ports nerfail_tpu/attacks/igsm2d.py, a re-design of attack_IGSM_2D.py
(reference :250-432): a perturbation bank [N, H, W, 3], one slice per
view; each batch takes the gradient of (1−β)·CE + β·MSE, a sign step of
size a, the ε-ball clamp and writes the slice back. The bank lives on the
host (it can exceed device memory at 400 views × 800²); each batch's
slice travels to the device and back.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerfail_tpu_torch.attacks.checkpoint import (
    clear_attack_state, load_attack_state, save_attack_state,
)
from nerfail_tpu_torch.attacks.forward import universal_2d_forward
from nerfail_tpu_torch.attacks.nerfail_s import AttackResult, _take
from nerfail_tpu_torch.config import AttackConfig
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device


def make_igsm2d_step(
    logits_fn: Callable, cfg: AttackConfig, resize_to: Optional[int]
) -> Callable:
    """(δ_b, ori_img, labels) → (δ_b', metrics), all on one device."""

    def step(delta_b, ori_img, labels):
        d = delta_b.detach().requires_grad_(True)
        out = universal_2d_forward(d, ori_img, logits_fn, resize_to,
                                   device=delta_b.device)
        ce = F.cross_entropy(out["logits"], labels)
        mse = torch.mean((out["attacked_rgb"] - ori_img[..., :3]) ** 2)
        loss = (1.0 - cfg.beta) * ce + cfg.beta * mse
        (grad,) = torch.autograd.grad(loss, d)
        with torch.no_grad():
            direction = -1.0 if cfg.targeted else 1.0
            new_delta = torch.clamp(
                delta_b + direction * cfg.a * torch.sign(grad),
                -cfg.eps, cfg.eps)
            preds = torch.argmax(out["logits"], dim=-1)
            ori_preds = torch.argmax(out["ori_logits"], dim=-1)
            metrics = {
                "loss": loss.detach(),
                "attacked_correct": torch.sum(preds == labels),
                "clean_correct": torch.sum(ori_preds == labels),
            }
        return new_delta, metrics

    return step


def igsm_2d_attack(
    ori_imgs,                    # [N, H, W, 4] 0-255
    labels: np.ndarray,
    logits_fn: Callable,
    cfg: AttackConfig,
    resize_to: Optional[int] = 299,
    log_fn: Optional[Callable] = None,
    epochs: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    device: DeviceLike = "cuda",
) -> AttackResult:
    """Per-view bank engine. `checkpoint_every` defaults to 10 (not 1):
    each save rewrites the whole [N, H, W, 3] bank (≈3 GB at 400×800²).
    The best bank is written to `<checkpoint_path>.best.npz`, and only on
    saves after it improved."""
    dev = resolve_device(device)
    n, H, W = ori_imgs.shape[:3]
    bank = np.zeros((n, H, W, 3), np.float32)
    labels = np.asarray(labels, np.int64)
    step_fn = make_igsm2d_step(logits_fn, cfg, resize_to)
    bs = cfg.batch_size
    epochs = epochs if epochs is not None else cfg.attack_epochs
    # best init = snapshot of the initial bank (the reference clones it,
    # attack_IGSM_2D.py:253); a live alias would mutate with the bank
    result = AttackResult(delta=bank.copy())
    fp = {"n_views": n, "view_shape": list(ori_imgs.shape[1:]),
          "eps": cfg.eps, "a": cfg.a, "targeted": cfg.targeted,
          "epochs": epochs, "engine": "igsm2d"}

    start_epoch = 0
    best_path = checkpoint_path + ".best.npz" if checkpoint_path else None
    if checkpoint_path:
        state = load_attack_state(checkpoint_path, fingerprint=fp)
        if state is not None:
            arrays, meta = state
            bank = arrays["bank"]
            best = load_attack_state(best_path, fingerprint=fp)
            result.delta = (best[0]["best_bank"] if best is not None
                            else bank.copy())
            result.best_attack_acc = meta["best_attack_acc"]
            result.history = meta["history"]
            start_epoch = meta["epoch"] + 1

    best_dirty = start_epoch == 0     # first save must seed the best file
    for epoch in range(start_epoch, epochs):
        attacked_correct = clean_correct = 0
        t0 = time.time()
        for s in range(0, n, bs):
            ids = np.arange(s, min(s + bs, n))
            new_delta, m = step_fn(
                torch.from_numpy(bank[ids]).to(dev),
                _take(ori_imgs, ids, dev).to(torch.float32),
                torch.from_numpy(labels[ids]).to(dev),
            )
            bank[ids] = new_delta.cpu().numpy()
            attacked_correct += int(m["attacked_correct"])
            clean_correct += int(m["clean_correct"])
        entry = {
            "epoch": epoch,
            "attack_acc": attacked_correct / n,
            "clean_acc": clean_correct / n,
            "time_s": time.time() - t0,
        }
        result.history.append(entry)
        if log_fn:
            log_fn(epoch, entry)
        if entry["attack_acc"] < result.best_attack_acc:
            result.best_attack_acc = entry["attack_acc"]
            result.delta = bank.copy()
            best_dirty = True
        if checkpoint_path and (epoch + 1) % checkpoint_every == 0:
            if best_dirty:
                save_attack_state(
                    best_path, {"best_bank": result.delta}, {},
                    fingerprint=fp,
                )
                best_dirty = False
            save_attack_state(
                checkpoint_path, {"bank": bank},
                {"epoch": epoch,
                 "best_attack_acc": result.best_attack_acc,
                 "history": result.history},
                fingerprint=fp,
            )
    clear_attack_state(checkpoint_path)
    clear_attack_state(best_path)
    return result
