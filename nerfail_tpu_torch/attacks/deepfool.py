"""DeepFool with class margins — the NeRFail inner solver.

Ports nerfail_tpu/attacks/deepfool.py, itself a re-design of the
reference's modified DeepFool (deepfool.py:10-111). The data-dependent
iteration (early exit on label flip, ≤ max_iter) is a Python loop over a
batch of views with a per-view `active` mask and one host sync per
iteration, for its any-active test; the single-view walk is the batch of
one. Exact semantics:

  margins:  untargeted → +m1 on the clean-prediction logit;
            targeted   → +m1 on every logit except the target
            (deepfool.py:53-57)
  stop:     margined argmax flips away from clean pred (or hits target)
  step:     f'_k   = logit_k − logit_clean − m2
            g_k    = ∇logit_k − ∇logit_clean
            k*     = argmin |f'_k| / (‖g_k‖ + 1e-4)   (first index on ties,
                                                      clean class excluded)
            dr     = |f'_k*| / (‖g_k*‖² + 1e-4) · g_k*
            rot   += dr
            δ      = clamp(δ₀ + overshoot·rot, −255, 255), alpha restored
  returns:  total delta = δ_final − δ₀ (deepfool.py:109-111)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class DeepFoolResult(NamedTuple):
    rot: torch.Tensor          # total perturbation delta (final − initial)
    iters: torch.Tensor        # iterations used (per view when batched)
    ori_label: torch.Tensor    # clean prediction
    final_label: torch.Tensor  # margined prediction at exit
    delta: torch.Tensor        # final perturbation tensor
    loops: int = 0             # loop iterations run (jacobian evaluations)


def _restore_alpha(new_delta: torch.Tensor, delta0: torch.Tensor,
                   preserve_alpha: bool) -> torch.Tensor:
    if not preserve_alpha:
        return new_delta
    return torch.cat([new_delta[..., :3], delta0[..., 3:4]], dim=-1)


def _logits_and_jacobian(logits_fn, delta, num_classes):
    """(logits [C, ...], d logits[k].sum() / d delta [C, *delta.shape]): one
    forward and one pullback per class, the last one freeing the graph."""
    d = delta.detach().requires_grad_(True)
    logits = logits_fn(d)
    jac = torch.stack([
        torch.autograd.grad(logits[k].sum(), d,
                            retain_graph=k + 1 < num_classes)[0]
        for k in range(num_classes)
    ])
    return logits.detach(), jac


def deepfool(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    delta0: torch.Tensor,
    ori_logits: torch.Tensor,     # [C] clean-image logits (constant)
    num_classes: int = 8,
    max_iter: int = 1000,
    m1: float = 1.0,
    m2: float = 30.0,
    overshoot: float = 0.02,
    targeted: bool = False,
    target_label: int = 0,
    preserve_alpha: bool = True,
) -> DeepFoolResult:
    """Run margin-DeepFool through `logits_fn` (δ → [C] logits): the walk
    of `deepfool_batch` with one view."""
    res = deepfool_batch(
        lambda d: logits_fn(d[0])[None], delta0, ori_logits[None],
        num_classes=num_classes, max_iter=max_iter, m1=m1, m2=m2,
        overshoot=overshoot, targeted=targeted, target_label=target_label,
        preserve_alpha=preserve_alpha,
    )
    return DeepFoolResult(*(t[0] for t in res[:5]), loops=res.loops)


def deepfool_batch(
    logits_fn_b: Callable[[torch.Tensor], torch.Tensor],
    delta0: torch.Tensor,         # shared start [p, H, W, 4] (or 2D shape)
    ori_logits_b: torch.Tensor,   # [V, C] clean logits per view
    num_classes: int = 8,
    max_iter: int = 1000,
    m1: float = 1.0,
    m2: float = 30.0,
    overshoot: float = 0.02,
    targeted: bool = False,
    target_label: int = 0,
    preserve_alpha: bool = True,
    jac_engine: Optional[Callable] = None,
) -> DeepFoolResult:
    """All V views walk margin-DeepFool simultaneously from one δ₀.

    `logits_fn_b` maps the batched perturbation [V, *δ] → [V, C]; the
    generic jacobian is one batched pullback per class. Per-view semantics
    are those of `deepfool`: each view stops on its own label flip (or
    freezes at max_iter while the others go on) and its rot is the view's
    total delta.

    `jac_engine` overrides the generic jacobian: δ_b [V, *δ], ori_label
    [V] → (logits [V, C], sq [V, C] = ‖∇(logit_k − logit_ori)‖², pick)
    where pick(k [V]) → gdiff [V, *δ] for each view's chosen class. The
    planned attack path supplies ops/splat.splat_deepfool_engine, which
    never materializes the [C, V, *δ] jacobian.

    Every loop iteration runs the whole body, the last one too (which
    finds every view flipped or frozen), so `loops` — the number of
    jacobian evaluations — is max over views of min(iters + 1, max_iter).
    """
    V = ori_logits_b.shape[0]
    dev = delta0.device
    ori_label = torch.argmax(ori_logits_b, dim=-1).to(dev)          # [V]
    if targeted:
        margin = m1 * (1.0 - F.one_hot(torch.tensor(target_label),
                                       num_classes).to(delta0.dtype))
        margin = margin.to(dev).expand(V, num_classes)
    else:
        margin = m1 * F.one_hot(ori_label, num_classes).to(delta0.dtype)
    views = torch.arange(V, device=dev)

    delta0_b = delta0.expand((V,) + delta0.shape)
    delta_b = delta0_b.clone()
    rot_b = torch.zeros_like(delta0_b)
    i = torch.zeros(V, dtype=torch.int32, device=dev)
    done = torch.zeros(V, dtype=torch.bool, device=dev)
    last_pred = ori_label
    loops = 0
    while bool(torch.any((i < max_iter) & ~done)):
        if jac_engine is not None:
            logits_b, sq, pick = jac_engine(delta_b, ori_label)
        else:
            logits_b, sq, pick = _generic_jacobian(
                logits_fn_b, delta_b, ori_label, num_classes)
        loops += 1
        with torch.no_grad():
            pred = torch.argmax(logits_b + margin, dim=-1)
            is_done = (pred == target_label) if targeted \
                else (pred != ori_label)
            # a view at max_iter without a flip freezes while others go on
            active = ~done & ~is_done & (i < max_iter)

            f = logits_b - logits_b[views, ori_label][:, None] - m2  # [V, C]
            value = torch.abs(f) / (torch.sqrt(sq) + 1e-4)
            if targeted:
                k = torch.full((V,), target_label, dtype=torch.int64,
                               device=dev)
            else:
                value[views, ori_label] = float("inf")
                k = torch.argmin(value, dim=-1)                     # [V]

            gdiff_k = pick(k).reshape((V,) + delta0.shape)
            scale = torch.abs(f[views, k]) / (sq[views, k] + 1e-4)  # [V]
            amask = active.to(delta_b.dtype).view(
                (V,) + (1,) * delta0.ndim)
            rot_b = rot_b + amask * scale.view(amask.shape) * gdiff_k
            delta_b = _restore_alpha(
                torch.clamp(delta0_b + overshoot * rot_b, -255.0, 255.0),
                delta0_b, preserve_alpha)
            i = i + active.to(i.dtype)
            done = done | is_done
            last_pred = pred
    return DeepFoolResult(
        rot=delta_b - delta0_b, iters=i, ori_label=ori_label,
        final_label=last_pred, delta=delta_b, loops=loops,
    )


def _generic_jacobian(logits_fn_b, delta_b, ori_label, num_classes):
    """The vjp jacobian: jac[c, v] = ∂logits[v, c]/∂δ_b[v], one batched
    pullback per class; sq without the [C, V, D] difference, by
    ‖a−b‖² = ‖a‖² − 2⟨a,b⟩ + ‖b‖²."""
    V = delta_b.shape[0]
    logits_b, jac = _logits_and_jacobian(
        lambda d: logits_fn_b(d).T, delta_b, num_classes)
    jacf = jac.reshape(num_classes, V, -1)
    views = torch.arange(V, device=delta_b.device)
    jac_ori = jacf[ori_label, views]                                # [V, D]
    nk = torch.sum(jacf * jacf, dim=-1).T                           # [V, C]
    cross = torch.einsum("cvd,vd->vc", jacf, jac_ori)
    n_ori = torch.sum(jac_ori * jac_ori, dim=-1)                    # [V]
    sq = torch.clamp(nk - 2.0 * cross + n_ori[:, None], min=0.0)

    def pick(k):
        return jacf[k, views] - jac_ori

    return logits_b.T, sq, pick
