"""NeRFail-S: IGSM-style sign-step attack on the shared 3D point set.

Re-designs attack_NeRFail_S.py (reference :27-453). Per epoch, for every
batch of views:

  loss  = (1-β)·CE(attacked logits, label) + β·MSE(attacked, clean)   (β=0)
  δ_rgb ← δ_rgb ± a·sign(∂loss/∂δ_rgb)      (+ untargeted, − targeted,
                                             attack_NeRFail_S.py:346-372)
  δ_rgb ← 0 outside the mask alpha
  δ_rgb ← clip into [δ₀−ε, δ₀+ε]            (ε-ball projection :384-392)

The splat backward runs the K1 segmented reduction over a CSR plan built
once per batch on the device that holds the tables, with background pairs
(ori_alpha == 0, provably zero gradient) dropped: the kernel on CUDA, its
plain version on the CPU. Tables and plans of each batch are kept on the
device under a byte budget (utils/device_cache).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerfail_tpu_torch.attacks.checkpoint import (
    clear_attack_state, load_attack_state, save_attack_state,
)
from nerfail_tpu_torch.attacks.forward import splat_attack_forward
from nerfail_tpu_torch.config import AttackConfig
from nerfail_tpu_torch.ops.cuda.segsum_kernel import CsrPlan, build_csr_plan
from nerfail_tpu_torch.utils.device_cache import DeviceBudgetCache
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device


def make_nerfail_s_step(
    logits_fn: Callable,
    cfg: AttackConfig,
    resize_to: Optional[int],
) -> Callable:
    """(δ, δ0, weights, idx, ori_img, labels, valid, plan) → (δ', metrics).

    All tensors on one device; `valid` masks the padded tail of a ragged
    last batch out of the loss and the counts. `plan` is the batch's
    CsrPlan for the splat backward."""

    def step(delta, delta0, weights, idx, ori_img, labels, valid,
             plan: CsrPlan):
        ori_img = ori_img.to(torch.float32)     # tables travel uint8
        n_valid = torch.clamp(torch.sum(valid), min=1.0)
        d = delta.detach().requires_grad_(True)
        out = splat_attack_forward(
            d.reshape(-1, 4), weights, idx, ori_img, logits_fn,
            eps=cfg.eps, resize_to=resize_to, plan=plan, device=delta.device,
        )
        # ragged tails are padded to the batch shape and masked out of the
        # loss (the reference DataLoader's partial final batch)
        ce = F.cross_entropy(out["logits"], labels.to(torch.int64),
                             reduction="none")
        ce = torch.sum(ce * valid) / n_valid
        per_mse = torch.mean((out["attacked_rgba"] - ori_img) ** 2,
                             dim=(1, 2, 3))
        mse = torch.sum(per_mse * valid) / n_valid
        loss = (1.0 - cfg.beta) * ce + cfg.beta * mse
        (grad,) = torch.autograd.grad(loss, d)

        with torch.no_grad():
            sign = torch.sign(grad[..., :3])
            direction = -1.0 if cfg.targeted else 1.0
            rgb = delta[..., :3] + direction * cfg.a * sign
            alpha = delta[..., 3:4]
            rgb = torch.where(alpha > 0, rgb, torch.zeros_like(rgb))
            # ε-ball around the initial tensor
            rgb = torch.clamp(rgb, delta0[..., :3] - cfg.eps,
                              delta0[..., :3] + cfg.eps)
            new_delta = torch.cat([rgb, alpha], dim=-1)
            preds = torch.argmax(out["logits"], dim=-1)
            ori_preds = torch.argmax(out["ori_logits"], dim=-1)
            metrics = {
                "loss": loss.detach(),
                "attacked_correct": torch.sum((preds == labels) * valid),
                "clean_correct": torch.sum((ori_preds == labels) * valid),
                "eps_min": out["eps_min"],
                "eps_max": out["eps_max"],
            }
        return new_delta, metrics

    return step


@dataclass
class AttackResult:
    delta: np.ndarray                  # best perturbation stack [p, H, W, 4]
    history: List[Dict] = field(default_factory=list)
    best_attack_acc: float = 1.0


def _take(arr, ids: np.ndarray, dev: torch.device) -> torch.Tensor:
    """arr[ids] on `dev`, for a numpy array or a tensor on any device."""
    if isinstance(arr, torch.Tensor):
        return arr[torch.as_tensor(ids, device=arr.device)].to(dev)
    return torch.from_numpy(np.ascontiguousarray(arr[ids])).to(dev)


def nerfail_s_attack(
    delta0,                      # [p, H, W, 4] zero-init mask stack
    weights,                     # [N, H, W, 8] per-view gaussian weights
    idx,                         # [N, H, W, 8]
    ori_imgs,                    # [N, H, W, 4] clean views (0-255)
    labels,                      # [N] true class (or target if targeted)
    logits_fn: Callable,
    cfg: AttackConfig,
    resize_to: Optional[int] = 299,
    log_fn: Optional[Callable] = None,
    epochs: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    plan_device_budget: int = 2 << 30,
    plan_cache: Optional[DeviceBudgetCache] = None,
    delta_init: Optional[np.ndarray] = None,
    stop_at_acc: Optional[float] = None,
    device: DeviceLike = "cuda",
) -> AttackResult:
    """Host driver: epochs × batches, best-tensor tracking by attack acc.

    Tables may be numpy arrays or tensors; each batch's slice goes to
    `device` once and stays there under `plan_device_budget`.

    With `checkpoint_path`, (δ, best δ, epoch, history) persist every
    `checkpoint_every` epochs and an interrupted run resumes exactly where
    it stopped. `delta_init` warm-starts the walk while δ0 keeps defining
    the ε-ball. `stop_at_acc` ends the walk once the best attack accuracy
    reaches the threshold (it never changes a step).
    """
    dev = resolve_device(device)
    step_fn = make_nerfail_s_step(logits_fn, cfg, resize_to)
    n = ori_imgs.shape[0]
    bs = cfg.batch_size
    epochs = epochs if epochs is not None else cfg.attack_epochs
    delta0 = np.asarray(delta0, np.float32)
    M = delta0.reshape(-1, 4).shape[0]
    labels = np.asarray(labels, np.int64)
    cache = plan_cache or DeviceBudgetCache(plan_device_budget, device=dev)

    def build_batch(s: int) -> Tuple:
        ids, valid = _batch_ids(s, n, bs)
        w_b = _take(weights, ids, dev).to(torch.float32)
        idx_b = _take(idx, ids, dev)
        ori_b = _take(ori_imgs, ids, dev)
        plan = build_csr_plan(idx_b, w_b, M, pair_mask=ori_b[..., 3:] > 0)
        return (w_b, idx_b, ori_b, torch.from_numpy(labels[ids]).to(dev),
                torch.from_numpy(valid).to(dev), plan)

    delta = torch.from_numpy(
        delta0 if delta_init is None else np.asarray(delta_init, np.float32)
    ).to(dev)
    delta0_d = torch.from_numpy(delta0).to(dev)
    result = AttackResult(delta=delta0.copy())
    fingerprint = _fingerprint(cfg, n, ori_imgs.shape, epochs)

    start_epoch = 0
    if checkpoint_path:
        state = load_attack_state(checkpoint_path, fingerprint=fingerprint)
        if state is not None:
            arrays, meta = state
            delta = torch.from_numpy(arrays["delta"]).to(dev)
            result.delta = arrays["best_delta"]
            result.best_attack_acc = meta["best_attack_acc"]
            result.history = meta["history"]
            start_epoch = meta["epoch"] + 1

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        attacked_correct = clean_correct = 0
        for s in range(0, n, bs):
            batch = cache.get(s, lambda s=s: build_batch(s))
            delta, m = step_fn(delta, delta0_d, *batch)
            # device-side sums: no host sync inside the epoch
            attacked_correct = attacked_correct + m["attacked_correct"]
            clean_correct = clean_correct + m["clean_correct"]
        attack_acc = float(attacked_correct) / n
        entry = {
            "epoch": epoch,
            "attack_acc": attack_acc,
            "clean_acc": float(clean_correct) / n,
            "time_s": time.time() - t0,
        }
        result.history.append(entry)
        if log_fn:
            log_fn(epoch, entry)
        # ties update too — the latest tensor wins on equal acc
        # (attack_NeRFail_S.py:428-431 `<=`)
        if attack_acc <= result.best_attack_acc:
            result.best_attack_acc = attack_acc
            result.delta = delta.cpu().numpy()
        if checkpoint_path and (epoch + 1) % checkpoint_every == 0:
            save_attack_state(
                checkpoint_path,
                {"delta": delta.cpu().numpy(), "best_delta": result.delta},
                {"epoch": epoch,
                 "best_attack_acc": result.best_attack_acc,
                 "history": result.history},
                fingerprint=fingerprint,
            )
        if stop_at_acc is not None and result.best_attack_acc <= stop_at_acc:
            break
    clear_attack_state(checkpoint_path)
    return result


def _batch_ids(s: int, n: int, bs: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the ragged tail to the batch shape (valid-masked inside the
    step), so every batch has the same shapes."""
    ids = np.arange(s, min(s + bs, n))
    valid = np.ones(len(ids), np.float32)
    if len(ids) < bs:
        pad = bs - len(ids)
        ids = np.concatenate([ids, np.full(pad, ids[-1])])
        valid = np.concatenate([valid, np.zeros(pad, np.float32)])
    return ids, valid


def _fingerprint(cfg: AttackConfig, n: int, shape, epochs: int) -> Dict:
    """Checkpoint identity: a stale state from a run with different data
    or hyperparameters must not silently resume."""
    return {
        "n_views": n, "view_shape": list(shape[1:]),
        "eps": cfg.eps, "a": cfg.a, "beta": cfg.beta,
        "targeted": cfg.targeted, "epochs": epochs,
    }
