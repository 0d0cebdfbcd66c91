"""UAP-2D baseline: DeepFool-driven universal 2D perturbation.

Ports nerfail_tpu/attacks/uap2d.py, a re-design of attack_UAP_2D.py
(reference :219-374): one shared [H, W, 3] perturbation over all views;
per epoch, for each still-correct view run DeepFool (2D forward) and
accumulate + L∞-project the delta (`project_perturbation`, :224-229,319).

Views are processed in `cfg.view_batch`-sized groups through the generic
`deepfool_batch` (one batched pullback per class, no splat and hence no
K1/K2): the classifier runs at batch width and the host syncs once per
DeepFool iteration. Only views whose walk finished under `df_max_iter`
add to δ. view_batch=1 reproduces the reference's sequential
accumulation order exactly.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from nerfail_tpu_torch.attacks.checkpoint import (
    clear_attack_state, load_attack_state, save_attack_state,
)
from nerfail_tpu_torch.attacks.deepfool import deepfool_batch
from nerfail_tpu_torch.attacks.forward import universal_2d_forward
from nerfail_tpu_torch.attacks.nerfail import _nerfail_batch_ids
from nerfail_tpu_torch.attacks.nerfail_s import AttackResult, _take
from nerfail_tpu_torch.config import AttackConfig
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device


def project_perturbation(eps: float, p, delta: torch.Tensor) -> torch.Tensor:
    """L∞ clamp or L2 rescale (attack_UAP_2D.py:224-229)."""
    if p == 2:
        norm = torch.linalg.norm(delta.reshape(-1))
        return delta * torch.clamp(eps / torch.clamp(norm, min=1e-12),
                                   max=1.0)
    return torch.clamp(delta, -eps, eps)


def uap_2d_attack(
    ori_imgs,                    # [N, H, W, 4] 0-255
    logits_fn: Callable,
    cfg: AttackConfig,
    resize_to: Optional[int] = 299,
    log_fn: Optional[Callable] = None,
    epochs: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    device: DeviceLike = "cuda",
) -> AttackResult:
    """Epochs over view groups; best δ tracked by attack accuracy. With
    `checkpoint_path`, (δ, best δ, epoch, history) persist every
    `checkpoint_every` epochs and an interrupted run resumes exactly."""
    dev = resolve_device(device)
    n, H, W = ori_imgs.shape[:3]
    epochs = epochs if epochs is not None else cfg.attack_epochs
    view_batch = max(cfg.view_batch, 1)
    delta = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    result = AttackResult(delta=delta.cpu().numpy())
    fp = {"n_views": n, "view_shape": list(ori_imgs.shape[1:]),
          "eps": cfg.eps, "targeted": cfg.targeted, "epochs": epochs,
          "engine": "uap2d"}

    start_epoch = 0
    if checkpoint_path:
        state = load_attack_state(checkpoint_path, fingerprint=fp)
        if state is not None:
            arrays, meta = state
            delta = torch.from_numpy(arrays["delta"]).to(dev)
            result.delta = arrays["best_delta"]
            result.best_attack_acc = meta["best_attack_acc"]
            result.history = meta["history"]
            start_epoch = meta["epoch"] + 1

    @torch.no_grad()
    def eval_batch(d, ori):
        out = universal_2d_forward(d, ori, logits_fn, resize_to, device=dev)
        return out["logits"], out["ori_logits"]

    def df_group(d, ori, ori_logits, active):
        def logits_fn_b(delta_b):
            return universal_2d_forward(delta_b, ori, logits_fn, resize_to,
                                        device=dev)["logits"]

        res = deepfool_batch(
            logits_fn_b, d, ori_logits, num_classes=ori_logits.shape[-1],
            max_iter=cfg.df_max_iter, m1=cfg.m1, m2=cfg.m2,
            overshoot=cfg.overshoot, targeted=cfg.targeted,
            target_label=cfg.target_label, preserve_alpha=False,
        )
        use = active & (res.iters < cfg.df_max_iter)
        mask = use.to(d.dtype).view(-1, 1, 1, 1)
        return torch.sum(mask * res.rot, dim=0), use

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        attacked_correct = 0
        for s in range(0, n, view_batch):
            ids, valid = _nerfail_batch_ids(s, n, view_batch)
            ori = _take(ori_imgs, ids, dev).to(torch.float32)
            logits, ori_logits = eval_batch(delta, ori)
            preds = torch.argmax(logits, -1).cpu().numpy()
            ori_preds = torch.argmax(ori_logits, -1).cpu().numpy()
            same = (preds == ori_preds) & valid
            attacked_correct += int(same.sum())
            if not same.any():
                continue
            rot_sum, used = df_group(delta, ori, ori_logits,
                                     torch.from_numpy(same).to(dev))
            if bool(used.any()):
                delta = project_perturbation(cfg.eps, np.inf,
                                             delta + rot_sum)

        entry = {
            "epoch": epoch,
            "attack_acc": attacked_correct / n,
            "time_s": time.time() - t0,
        }
        result.history.append(entry)
        if log_fn:
            log_fn(epoch, entry)
        if entry["attack_acc"] < result.best_attack_acc:
            result.best_attack_acc = entry["attack_acc"]
            result.delta = delta.cpu().numpy()
        if checkpoint_path and (epoch + 1) % checkpoint_every == 0:
            save_attack_state(
                checkpoint_path,
                {"delta": delta.cpu().numpy(), "best_delta": result.delta},
                {"epoch": epoch,
                 "best_attack_acc": result.best_attack_acc,
                 "history": result.history},
                fingerprint=fp,
            )
    clear_attack_state(checkpoint_path)
    return result
