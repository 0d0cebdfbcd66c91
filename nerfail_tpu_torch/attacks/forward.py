"""The differentiable attack forward: 3D splat → composite → classify.

Re-designs `gauss_net.forward` (model/GaussNet.py:46-159) as functions on
tensors. Semantics preserved exactly (all in 0-255 pixel space, NHWC):

  s        = perturbation point set, [M, 4] RGBA (M = p·H·W)
  splat    = Σ_j w_j · s[idx_j]                     (8-NN gaussian gather)
  α        = splat_alpha / 255                      (GaussNet.py:85)
  r        = clip(splat_rgb · α, -ε, +ε)            (ε-clip INSIDE forward,
                                                     GaussNet.py:106-110)
  attacked = clip(where(ori_α>0, ori_rgb + r, 0) ∥ ori_α, 0, 255)
  white    = where(α>0, rgb, 255) for both attacked and clean
  resize   = bilinear to the classifier's input size, through the same
             antialiased matrices as the JAX package (jax.image.resize)
  logits   = classifier(white_attacked), classifier(white_clean)

plus `universal_2d_forward` (universal_2D_net, GaussNet.py:340-385) for
the 2D baselines, and the split forward `gauss_get_r` / `gauss_get_img`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from nerfail_tpu_torch.ops.cuda.segsum_kernel import CsrPlan
from nerfail_tpu_torch.ops.splat import splat_gather, splat_gather_batched
from nerfail_tpu_torch.pointset.weights import gauss_weights
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device
from nerfail_tpu_torch.utils.profiling import span, span_to_grad


def make_classifier_logits_fn(
    model: nn.Module,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval-mode classifier: [B, S, S, 3] 0-255 floats → [B, C] logits.

    The attack takes a frozen classifier: the model is put in eval mode
    (BN running statistics, no dropout) and its parameters stop requiring
    grad, so the clean-image forward keeps no autograd graph and the
    backward computes input gradients only."""
    model.eval().requires_grad_(False)

    def logits_fn(x: torch.Tensor) -> torch.Tensor:
        return model(x)

    return logits_fn


def white_composite_255(rgb: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """rgb where alpha>0 else 255 (GaussNet.py:127-145)."""
    return torch.where(alpha > 0, rgb, torch.full_like(rgb, 255.0))


@lru_cache(maxsize=8)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear-resize matrix along one axis, as float32.

    The matrix of jax.image.resize(method="bilinear", antialias=True)
    along a resized axis (jax/_src/image/scale.py compute_weight_mat,
    translation 0): a triangle kernel widened by the scale factor when
    downscaling, columns normalised to sum 1, samples outside the input
    zeroed."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.0)
                - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, np.float32(1.0)),
        np.float32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, np.float32(0.0))
    return np.ascontiguousarray(weights.T.astype(np.float32))


@lru_cache(maxsize=8)
def _resize_matrix(n_in: int, n_out: int,
                   device: torch.device) -> torch.Tensor:
    """`_resize_weights` on `device`, sent there once: a resize on the card
    then makes no copy from the host, which would block the host until
    the card's queue has drained."""
    return torch.from_numpy(_resize_weights(n_in, n_out)).to(device)


def _resize_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    A = _resize_matrix(x.shape[axis], n_out, x.device)
    x = torch.movedim(x, axis, -1)
    y = torch.matmul(x, A.T)
    return torch.movedim(y, -1, axis)


def resize_batch(x: torch.Tensor, size: Optional[int]) -> torch.Tensor:
    """Differentiable bilinear resize of [B, H, W, C] to [B, size, size, C]
    as two matrix products (W axis, then H axis)."""
    if size is None or x.shape[1] == size:
        return x
    y = _resize_axis(x, size, axis=2)
    return _resize_axis(y, size, axis=1)


def composite_after_splat(
    splat: torch.Tensor,         # [B, H, W, 4] splatted perturbation
    ori_img: torch.Tensor,       # [B, H, W, 4] clean RGBA (0-255)
    eps: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Everything between the splat output and the classifier input
    (GaussNet.py:85-154)."""
    alpha = splat[..., 3:4] / 255.0
    ori_alpha = ori_img[..., 3:4]

    r = splat[..., :3] * alpha
    # effective 3D perturbation range diagnostic (GaussNet.py:89-103)
    r_masked = torch.where(alpha > 0, r, torch.zeros_like(r))
    eps_min, eps_max = torch.aminmax(r_masked.detach())
    if eps is not None:
        r = torch.clamp(r, -eps, eps)

    x_rgb = ori_img[..., :3] + r
    x_rgb = torch.where(ori_alpha > 0, x_rgb, torch.zeros_like(x_rgb))
    x_rgba = torch.clamp(torch.cat([x_rgb, ori_alpha], dim=-1), 0.0, 255.0)
    return {
        "attacked_rgba": x_rgba,
        "cla_x": white_composite_255(x_rgba[..., :3], ori_alpha),
        "eps_min": eps_min,
        "eps_max": eps_max,
    }


def splat_attack_forward(
    point_rgba,                  # [M, 4] point set (0-255), or [B, M, 4]
    weights,                     # [B, H, W, 8]
    idx,                         # [B, H, W, 8] int into point set
    ori_img,                     # [B, H, W, 4] clean RGBA (0-255)
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    eps: Optional[float] = None,
    resize_to: Optional[int] = 299,
    plan: Optional[CsrPlan] = None,   # CSR plan for the splat backward
    device: DeviceLike = "cuda",
    mesh=None,                   # process mesh: B is this rank's views
    ori_logits: Optional[torch.Tensor] = None,   # [B, C] clean logits
) -> Dict[str, torch.Tensor]:
    """Returns dict(splat, attacked_rgba, logits, ori_logits, eps_min,
    eps_max). Array inputs are moved to `device`; a tensor already there
    (a δ that requires grad) is used as it is.

    Given `ori_logits` (the clean views' logits from an earlier call with
    the same frozen `logits_fn`), the clean composite, resize and
    classification are skipped and the tensor is returned as it is.

    A 3-D `point_rgba` [B, M, 4] means each view carries its own perturbed
    copy of the point set (the batched-DeepFool inner state); `plan` must
    then come from build_batched_csr_plan. With a `mesh` the B views are
    this rank's slice of the batch (the JAX forward shards the view axis
    over "data"): a shared point set's gradient is all-reduced over the
    "data" group in the splat backward, and the outputs stay per rank."""
    with span("attack.forward"):
        dev = resolve_device(device)
        point_rgba = torch.as_tensor(point_rgba, device=dev)
        weights = torch.as_tensor(weights, device=dev)
        idx = torch.as_tensor(idx, device=dev)
        ori_img = torch.as_tensor(ori_img, device=dev).to(torch.float32)
        with span("attack.splat"):
            if point_rgba.ndim == 3:
                splat = splat_gather_batched(point_rgba, idx, weights,
                                             plan=plan, mesh=mesh)
            else:
                splat = splat_gather(point_rgba, idx, weights, plan=plan,
                                     mesh=mesh)
        with span("attack.composite"):
            out = composite_after_splat(splat, ori_img, eps=eps)
            if ori_logits is None:
                cla_ori = white_composite_255(ori_img[..., :3],
                                              ori_img[..., 3:4])
        out["splat"] = splat
        with span("attack.resize"):
            x = resize_batch(out.pop("cla_x"), resize_to)
        # the backward's classifier part ends where x's gradient is made
        span_to_grad(x, "attack.classify_backward")
        with span("attack.classify"):
            out["logits"] = logits_fn(x)
        if ori_logits is None:
            with span("attack.resize"):
                x = resize_batch(cla_ori, resize_to)
            with span("attack.classify"):
                ori_logits = logits_fn(x)
        out["ori_logits"] = ori_logits
    return out


def universal_2d_forward(
    delta,                       # [H, W, 3] or [B, H, W, 3] (0-255 space)
    ori_img,                     # [B, H, W, 4] clean RGBA (0-255)
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    resize_to: Optional[int] = 299,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """2D baseline forward (universal_2D_net, GaussNet.py:356-385):
    broadcast-add the perturbation, clip, white-composite, classify.
    Array inputs are moved to `device`; a tensor already there is used as
    it is."""
    dev = resolve_device(device)
    delta = torch.as_tensor(delta, device=dev)
    ori_img = torch.as_tensor(ori_img, device=dev).to(torch.float32)
    ori_alpha = ori_img[..., 3:4]
    if delta.ndim == 3:
        delta = delta[None]
    x_rgb = torch.clamp(ori_img[..., :3] + delta, 0.0, 255.0)
    cla_x = white_composite_255(x_rgb, ori_alpha)
    cla_ori = white_composite_255(ori_img[..., :3], ori_alpha)
    return {
        "attacked_rgb": cla_x,
        "logits": logits_fn(resize_batch(cla_x, resize_to)),
        "ori_logits": logits_fn(resize_batch(cla_ori, resize_to)),
    }


def gauss_get_r(
    point_rgba,                  # [M, 4] perturbation point set (0-255)
    dist,                        # [B, H, W, 8] raw 8-NN distances
    idx,                         # [B, H, W, 8]
    c: float = 0.02,
    eps_reg: float = 0.001,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Split variant 1 (GaussNet.py:189-268 `gauss_get_r`): convert raw
    distances to gaussian weights inline, then splat → effective per-pixel
    perturbation r [B, H, W, 3] (alpha-modulated)."""
    dev = resolve_device(device)
    w = gauss_weights(torch.as_tensor(dist, device=dev), c=c, eps=eps_reg)
    splat = splat_gather(torch.as_tensor(point_rgba, device=dev),
                         torch.as_tensor(idx, device=dev), w)
    return splat[..., :3] * (splat[..., 3:4] / 255.0)


def gauss_get_img(
    r,                           # [B, H, W, 3] effective perturbation
    ori_img,                     # [B, H, W, 4] clean RGBA (0-255)
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    eps: Optional[float] = None,
    resize_to: Optional[int] = 299,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """Split variant 2 (GaussNet.py:271-337 `gauss_get_img`): composite a
    precomputed r onto the clean image and classify both."""
    dev = resolve_device(device)
    r = torch.as_tensor(r, device=dev)
    ori_img = torch.as_tensor(ori_img, device=dev).to(torch.float32)
    ori_alpha = ori_img[..., 3:4]
    if eps is not None:
        r = torch.clamp(r, -eps, eps)
    x_rgb = ori_img[..., :3] + r
    x_rgb = torch.where(ori_alpha > 0, x_rgb, torch.zeros_like(x_rgb))
    x_rgba = torch.clamp(torch.cat([x_rgb, ori_alpha], dim=-1), 0.0, 255.0)
    cla_x = white_composite_255(x_rgba[..., :3], ori_alpha)
    cla_ori = white_composite_255(ori_img[..., :3], ori_alpha)
    return {
        "attacked_rgba": x_rgba,
        "logits": logits_fn(resize_batch(cla_x, resize_to)),
        "ori_logits": logits_fn(resize_batch(cla_ori, resize_to)),
    }


def zero_init_mask(mask_images: torch.Tensor) -> torch.Tensor:
    """Initial perturbation stack: RGB zeroed, alpha kept
    (attack_NeRFail.py:276-282). mask_images: [p, H, W, 4] 0-255."""
    mask_images = torch.as_tensor(mask_images)
    return torch.cat(
        [torch.zeros_like(mask_images[..., :3]), mask_images[..., 3:4]],
        dim=-1,
    )
