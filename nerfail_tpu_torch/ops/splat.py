"""Differentiable 8-NN Gaussian splat: point-set RGBA → per-pixel RGBA.

The heart of every attack iteration (reference GaussNet.py:60-119): each
pixel gathers its 8 nearest point-set entries and blends them with
precomputed Gaussian weights,

    out = Σ_j w_j · points[idx_j].

Forward: a plain gather and weighted sum. Backward: the transpose, a
scatter-add of pixel gradients into the point tensor, run by the K1
segmented reduction over a CSR plan (ops/cuda/segsum_kernel) — the
kernel on CUDA, its plain version on the CPU. idx and w are static tables
in every attack, so no cotangent is produced for w.

The batched DeepFool walks carry one perturbed copy of the point set per
view ([V, M, C]); `splat_gather_batched` splats each view from its own
copy, and `splat_deepfool_engine` gives one DeepFool iteration's class
norms through K2 without the per-class jacobian.

With a process `mesh` (parallel/mesh.py) each rank splats its own views:
the shared-point backward sums its K1 result over the "data" group
(`segment_sum_sharded`); per-view point copies keep their cotangents, the
engine's class norms and its pick view-local, as the JAX package's
`shard_map`s give them P("data") outputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
    CsrPlan, build_csr_plan, segment_sq, segment_sum, segment_sum_class,
    segment_sum_sharded,
)


def _gather_rows(points: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """points[flat_idx] for [M, C] float32 points.

    PyTorch's gathers copy 4-byte elements one at a time, which is far
    slower on the card than moving a whole row; an RGBA row (C = 4, 16
    bytes) is therefore gathered as one complex128 element and viewed
    back, a bit-exact copy."""
    if (points.shape[-1] == 4 and points.dtype == torch.float32
            and points.is_contiguous() and points.storage_offset() % 4 == 0):
        rows = points.view(torch.complex128).index_select(0, flat_idx)
        return rows.view(torch.float32)
    return points.index_select(0, flat_idx)


def splat_forward(points: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """points [M, C], idx [..., k], w [..., k] → [..., C]."""
    C = points.shape[-1]
    gathered = _gather_rows(points, idx.reshape(-1))
    gathered = gathered.reshape(*idx.shape, C)
    return torch.sum(w[..., None] * gathered, dim=-2)


class _SplatGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx, w, plan, mesh):
        ctx.num_points = points.shape[0]
        ctx.plan = plan
        ctx.mesh = mesh
        if plan is None:
            ctx.save_for_backward(idx, w)
        return splat_forward(points, idx, w)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        if plan is None:
            idx, w = ctx.saved_tensors
            plan = build_csr_plan(idx, w, ctx.num_points)
        C = g.shape[-1]
        g = g.reshape(-1, C).contiguous()
        if ctx.mesh is None:
            d_points = segment_sum(g, plan)
        else:
            d_points = segment_sum_sharded(g, plan, ctx.mesh, reduce=True)
        return d_points, None, None, None, None


def splat_gather(points: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 plan: Optional[CsrPlan] = None, mesh=None) -> torch.Tensor:
    """points [M, C], idx [..., k] int, w [..., k] → [..., C].

    With a `CsrPlan` (built once per table batch, e.g. with background
    pairs dropped) the backward uses it; without one, the backward
    builds an unmasked plan from idx and w. With a `mesh` as well, idx
    and w are this rank's views (the plan built over them alone) and the
    [M, C] cotangent is all-reduced over the "data" group: the multi-view
    gradient all-reduce of the shared point set."""
    if plan is not None:
        plan.check(points.shape[0], idx[..., 0].numel())
    return _SplatGather.apply(points, idx, w, plan, mesh)


def _view_offsets(idx: torch.Tensor, M: int) -> torch.Tensor:
    """idx [V, ..., k] into per-view point sets → ids into the [V·M] rows
    of the stacked sets."""
    V = idx.shape[0]
    if V * M >= 2 ** 31:
        raise ValueError("V·M must fit int32")
    off = torch.arange(V, device=idx.device, dtype=idx.dtype) * M
    return idx + off.view(V, *([1] * (idx.ndim - 1)))


def splat_forward_batched(points_b: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """points_b [V, M, C], idx/w [V, ..., k] → [V, ..., C], view v from
    its own point set."""
    V, M, C = points_b.shape
    return splat_forward(points_b.reshape(V * M, C), _view_offsets(idx, M), w)


def splat_gather_batched(points_b: torch.Tensor, idx: torch.Tensor,
                         w: torch.Tensor,
                         plan: Optional[CsrPlan] = None,
                         mesh=None) -> torch.Tensor:
    """Per-view splat: out[v] = Σ_j w[v]_j · points_b[v][idx[v]_j].

    points_b [V, M, C], idx/w [V, ..., k] → [V, ..., C]. The backward is
    one K1 pass over the [V·M] output rows: with `plan` from
    build_batched_csr_plan it uses that plan, without one it builds an
    unmasked plan from idx and w. Under a `mesh` the views are this
    rank's and their cotangents stay its own: no collective."""
    V, M, C = points_b.shape
    if plan is not None:
        plan.check(V * M, idx[..., 0].numel())
    return _SplatGather.apply(points_b.reshape(V * M, C),
                              _view_offsets(idx, M), w, plan, None)


def deepfool_cotangents(
    head_fn: Callable[[torch.Tensor], torch.Tensor],
    pix: torch.Tensor,            # [V, ..., C] splatted views
    num_classes: int,
    ori_label: torch.Tensor,      # [V] clean predictions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [V, ncls], Gdiff [V·n_pix, ncls·C]).

    One forward through `head_fn` (composite, resize, classifier) and one
    pullback per class: G[v, pix, k, :] = ∂logit_k(v)/∂pix[v] (cross-view
    derivatives are zero by construction), then Gdiff_k = G_k − G_ori,
    in place. The stack is pixel-major so that every pair of K1/K2 reads
    its channels as one contiguous row."""
    V, C = pix.shape[0], pix.shape[-1]
    n_pix = pix[0, ..., 0].numel()
    pix = pix.detach().requires_grad_(True)
    logits = head_fn(pix)
    G = torch.empty(V, n_pix, num_classes, C, dtype=pix.dtype,
                    device=pix.device)
    for k in range(num_classes):
        # the last pullback frees the graph
        (gk,) = torch.autograd.grad(logits[:, k].sum(), pix,
                                    retain_graph=k + 1 < num_classes)
        G[:, :, k] = gk.reshape(V, n_pix, C)
    views = torch.arange(V, device=pix.device)
    G -= G[views, :, ori_label.to(pix.device)].unsqueeze(2)
    return logits.detach(), G.view(V * n_pix, num_classes * C)


def splat_deepfool_engine(
    head_fn: Callable[[torch.Tensor], torch.Tensor],
    points_b: torch.Tensor,       # [V, M, C] per-view point tensors
    idx: torch.Tensor,            # [V, ..., k]
    w: torch.Tensor,              # [V, ..., k]
    plan: CsrPlan,                # from build_batched_csr_plan
    num_classes: int,
    ori_label: torch.Tensor,      # [V] clean predictions
    mesh=None,
):
    """One DeepFool iteration's jacobian quantities without the jacobian.

    Returns (logits [V, ncls], sq [V, ncls], pick) where
    sq[v, k] = ‖∂(logit_k − logit_ori)/∂points_b[v]‖² and
    pick(k [V]) → gdiff [V, M, C] for each view's chosen class.

    The per-class jacobian [ncls, V, M, C] never exists. The splat forward
    runs once; `deepfool_cotangents` pulls each class back through
    `head_fn` only, into a pixel-major stack of ncls·C ≤ 32 channels; ONE
    K2 launch gives every class's squared norm per view (the four RGBA
    channels of a class are then added); `pick` runs one K1 launch that
    reads each view's chosen class out of the stack in place.

    Under a `mesh` the V views are this rank's, with the plan built over
    them: the norms and the pick are view-local and need no collective
    (the JAX engine's P("data") outputs), so a rank may walk more or
    fewer DeepFool iterations than another."""
    V, M, C = points_b.shape
    plan.check(V * M, idx[..., 0].numel())
    with torch.no_grad():
        pix = splat_forward_batched(points_b, idx, w)
    logits, G = deepfool_cotangents(head_fn, pix, num_classes, ori_label)
    sq = segment_sq(G, plan).view(V, num_classes, C).sum(-1)

    def pick(k: torch.Tensor) -> torch.Tensor:            # k [V] → [V, M, C]
        return segment_sum_class(G, k, plan, C).view(V, M, C)

    return logits, sq, pick
