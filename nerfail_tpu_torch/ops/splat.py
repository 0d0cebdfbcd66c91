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
"""

from __future__ import annotations

from typing import Optional

import torch

from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
    CsrPlan, build_csr_plan, segment_sum,
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
    def forward(ctx, points, idx, w, plan):
        ctx.num_points = points.shape[0]
        ctx.plan = plan
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
        d_points = segment_sum(g.reshape(-1, C).contiguous(), plan)
        return d_points, None, None, None


def splat_gather(points: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 plan: Optional[CsrPlan] = None) -> torch.Tensor:
    """points [M, C], idx [..., k] int, w [..., k] → [..., C].

    With a `CsrPlan` (built once per table batch, e.g. with background
    pairs dropped) the backward uses it; without one, the backward
    builds an unmasked plan from idx and w."""
    if plan is not None:
        plan.check(points.shape[0], idx[..., 0].numel())
    return _SplatGather.apply(points, idx, w, plan)
