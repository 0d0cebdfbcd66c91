"""K1: the splat backward's segmented reduction, as a CSR plan + CUDA kernel.

    d_points[m, c] = Σ over kept pairs p of point m of  w[p] · g[pix[p], c]

Replaces nerfail_tpu/ops/pallas/segsum_kernel.py `_segsum_kernel` (via
`_part_compact_sums`, exposed as `planned_segment_sum`). The TPU design
buckets pairs into 512-id chunks and width classes so that a one-hot MXU
contraction can stand in for a scatter; Hopper scatters and gathers
well, so the port keeps only what the reduction needs:

  * plan (`build_csr_plan`), built once per attack batch because the
    tables are static: drop masked pairs, stable-sort the kept pairs by
    point id (pixel order within a point stays fixed), and store
    row_ptr int32 [M+1], pix int32 [P], w f32 [P]. It is built with
    torch ops on the device that holds the tables (the card on the main
    path): plan building is glue, not the kernel;
  * kernel (`csrc/segsum.cu`): one 8-lane group per point, g gathered
    inside the kernel, fp32 sums in registers, no atomics, so the result
    is bit-identical from run to run. Memory-bound: the kept pairs' plan
    bytes, the touched rows of g, row_ptr and the [M, C] output.

`segment_sum` launches the kernel for CUDA tensors and raises on anything
it cannot take; for CPU tensors it runs `segment_sum_plain`, an
`index_add_` of w·g[pix] in fp32 that the CPU tests compare with the JAX
package.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from nerfail_tpu_torch.ops.cuda import build

MAX_CHANNELS = 32


@dataclass(frozen=True)
class CsrPlan:
    """Pairs grouped by point id. `num_points`/`n_pixels` let the splat
    check the plan against the tensors it is applied to, so a stale plan
    raises instead of mis-summing."""

    row_ptr: torch.Tensor    # int32 [M+1], pairs of point m: row_ptr[m]:row_ptr[m+1]
    pix: torch.Tensor        # int32 [P] pixel row feeding each pair
    w: torch.Tensor          # f32 [P] the pair's static gaussian weight
    num_points: int
    n_pixels: int

    @property
    def n_pairs(self) -> int:
        return int(self.pix.numel())

    @property
    def device(self) -> torch.device:
        return self.pix.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.row_ptr, self.pix, self.w))

    def to(self, device, non_blocking: bool = False) -> "CsrPlan":
        return CsrPlan(
            *(t.to(device, non_blocking=non_blocking)
              for t in (self.row_ptr, self.pix, self.w)),
            num_points=self.num_points, n_pixels=self.n_pixels,
        )

    def check(self, num_points: int, n_pixels: int) -> None:
        if self.num_points != num_points:
            raise ValueError(
                f"plan covers {self.num_points} points, tensor has "
                f"{num_points} — stale plan?"
            )
        if self.n_pixels != n_pixels:
            raise ValueError(
                f"plan was built for {self.n_pixels} pixels, batch has "
                f"{n_pixels} — stale plan?"
            )


def build_csr_plan(
    idx: torch.Tensor,                       # [..., k] point ids
    weights: torch.Tensor,                   # [..., k]
    num_points: int,
    pair_mask: Optional[torch.Tensor] = None,  # bool, broadcastable to idx
) -> CsrPlan:
    """CSR layout of the (pixel, neighbour) pairs of one table batch, on
    idx's device. False pairs of `pair_mask` are dropped (background
    pixels, whose gradient is identically zero)."""
    k = idx.shape[-1]
    dev = idx.device
    flat = idx.reshape(-1)
    w = weights.expand(idx.shape).reshape(-1).to(torch.float32)
    pix = torch.arange(flat.numel(), device=dev, dtype=torch.int64) // k
    if pair_mask is not None:
        keep = pair_mask.to(dev).expand(idx.shape).reshape(-1)
        flat, w, pix = flat[keep], w[keep], pix[keep]
    if flat.numel():
        lo, hi = int(flat.min()), int(flat.max())
        if lo < 0 or hi >= num_points:
            raise ValueError(
                f"neighbor index range [{lo}, {hi}] out of range for a "
                f"{num_points}-point set — idx table and perturbation "
                "point set disagree"
            )
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=num_points)
    row_ptr = torch.zeros(num_points + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return CsrPlan(
        row_ptr=row_ptr,
        pix=pix[order].to(torch.int32),
        w=w[order].contiguous(),
        num_points=num_points,
        n_pixels=idx.numel() // k,
    )


def plan_point_ids(plan: CsrPlan) -> torch.Tensor:
    """int64 [P] point id of every pair (expands row_ptr)."""
    counts = (plan.row_ptr[1:] - plan.row_ptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(plan.num_points, device=plan.device), counts
    )


def segment_sum_plain(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """The plain PyTorch version: index_add_ of w·g[pix] in fp32."""
    contrib = plan.w[:, None] * g[plan.pix.to(torch.int64)]
    out = torch.zeros(plan.num_points, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, plan_point_ids(plan), contrib)


def error_bound(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """[M, C] bound on |kernel − plain|: both sum the same rounded products
    of a point's n pairs, in two orders, so each is within (n−1)·u·Σ|w·g|
    of the exact sum (u = 2⁻²⁴); the bound adds one more u·Σ|w·g| for
    rounding in Σ|w·g| itself."""
    n = (plan.row_ptr[1:] - plan.row_ptr[:-1]).to(torch.float32)[:, None]
    abs_plan = CsrPlan(plan.row_ptr, plan.pix, plan.w.abs(),
                       plan.num_points, plan.n_pixels)
    return (2 * n + 1) * 2.0 ** -24 * segment_sum_plain(g.abs(), abs_plan)


def _launcher():
    fn = build.load("segsum").segsum_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_sum(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """d_points [M, C] = Σ_pairs w·g[pix] grouped by point.

    g [n_pixels, C] f32. CUDA tensors launch the kernel (and count the
    launch in `segment_sum.launches`); CPU tensors take the plain
    version."""
    if g.ndim != 2:
        raise ValueError(f"g must be [n_pixels, C], got {tuple(g.shape)}")
    if g.shape[0] != plan.n_pixels:
        raise ValueError(
            f"plan was built for {plan.n_pixels} pixels, g has {g.shape[0]}"
        )
    if g.device.type == "cpu":
        return segment_sum_plain(g, plan)
    if g.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {g.device}")
    C = g.shape[1]
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("segment_sum: g must be contiguous float32")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"segment_sum: C={C} outside 1..{MAX_CHANNELS}")
    for name, t, dt in (("row_ptr", plan.row_ptr, torch.int32),
                        ("pix", plan.pix, torch.int32),
                        ("w", plan.w, torch.float32)):
        if t.device != g.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"segment_sum: plan.{name} must be contiguous {dt} on "
                f"{g.device}, got {t.dtype} on {t.device}"
            )
    out = torch.empty(plan.num_points, C, dtype=torch.float32,
                      device=g.device)
    if C == 4 and (g.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("segment_sum: C=4 rows must be 16-byte aligned")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _launcher()(
            plan.row_ptr.data_ptr(), plan.pix.data_ptr(), plan.w.data_ptr(),
            g.data_ptr(), out.data_ptr(), plan.num_points, C, stream,
        )
    build.check(status, "segsum_launch")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
