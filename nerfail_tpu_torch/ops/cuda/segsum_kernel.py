"""K1 and K2: the splat backward's segmented reductions over a CSR plan.

K1  d_points[m, c] = Σ over kept pairs p of point m of  w[p] · g[pix[p], c]
K2  sq[v, c]       = Σ over the points m of view v of   d_points[m, c]²

K1 replaces nerfail_tpu/ops/pallas/segsum_kernel.py `_segsum_kernel` (via
`_part_compact_sums`, exposed as `planned_segment_sum[_T]`); K2 replaces
`_segsum_sq_kernel` (via `_part_compact_sq`, exposed as
`planned_segment_sq[_T]`), the batched-DeepFool class-norm pass. The TPU
design buckets pairs into 512-id chunks and width classes so that a
one-hot MXU contraction can stand in for a scatter; Hopper scatters and
gathers well, so the port keeps only what the reductions need:

  * plan, built once per attack batch because the tables are static: drop
    masked pairs, stable-sort the kept pairs by output row (pixel order
    within a row stays fixed), and list only the rows some pair touches:
    rows int32 [R] (ascending output rows), row_ptr int32 [R+1], pix int32
    [P], w f32 [P], and view_ptr int32 [V+1], each view's range of plan
    rows. launch_rows int32 [R, 4] is the kernels' table of the plan
    rows, (row_ptr[r], row_ptr[r+1], rows[r], view) for each row r in
    plan-row order, so that a kernel starts a row with one 16-byte load.
    Both kernels walk the rows in the order of this table; any order that
    keeps each view's rows in its range gives K1 the same bits (the Morton
    order of each row's first pixel measured slower; PERF.md, Findings).
    `build_batched_csr_plan` serves per-view point copies: view v's
    pairs address rows v·M + m of a [V·M] output. `build_csr_plan` is its
    one-view case, for a point set that every pixel of the batch shares.
    A view touches a small part of its M, and an idle lane group per
    empty row is real time at V·M = 15.36 M. Plans are built with torch
    ops on the device that holds the tables (the card on the main path):
    plan building is glue, not the kernel;
  * K1 (`csrc/segsum.cu`): one 8-lane group per plan row, g gathered
    inside the kernel, fp32 sums in registers, no atomics, so the result
    is bit-identical from run to run and in any launch order. The output
    is zero-filled first and the kernel writes the touched rows.
    Memory-bound: the kept pairs' plan bytes, the touched rows of g, rows
    and row_ptr, and the [M, C] output.
    `segment_sum_class` is K1 on one class per view of the DeepFool
    engine's pixel-major [n_pixels, ncls·C] stack, read in place;
  * K2 (`csrc/segsum_sq.cu`): the same row sums, squared in registers and
    never written; 4 lanes a row, a pair's 32 channels one 128-byte
    request; each block writes per-view partial squares, and the view's
    last block adds them in a fixed order. No float atomics, so the
    result is bit-identical from run to run (the DeepFool argmin depends
    on it). Memory-bound: plan bytes and the touched rows of the
    [n_pixels, C] cotangent stack.

`segment_sum` / `segment_sum_class` / `segment_sq` launch the kernels for
CUDA tensors and raise on anything they cannot take; for CPU tensors they
run `segment_sum_plain` / `segment_sum_class_plain` / `segment_sq_plain`,
which the CPU tests compare with the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from nerfail_tpu_torch.ops.cuda import build

MAX_CHANNELS = 32

# K2's reduction tree, as in csrc/segsum_sq.cu (sq_error_bound reads it)
SQ_GROUPS = 64               # lane groups per block, each on one plan row
SQ_ROWS_PER_GROUP = 8        # plan rows a lane group squares and adds
SQ_ROWS_PER_BLOCK = SQ_GROUPS * SQ_ROWS_PER_GROUP
SQ_FIN = 8                   # strided runs of the view's final sum
SQ_TICKET_STRIDE = 32        # ints between two views' ticket counters

U32 = 2.0 ** -24             # fp32 unit roundoff


@dataclass(frozen=True)
class CsrPlan:
    """Pairs grouped by output row, touched rows only. `num_points` /
    `n_pixels` let the splat check the plan against the tensors it is
    applied to, so a stale plan raises instead of mis-summing."""

    row_ptr: torch.Tensor    # int32 [R+1], pairs of plan row r: row_ptr[r]:row_ptr[r+1]
    pix: torch.Tensor        # int32 [P] pixel row feeding each pair
    w: torch.Tensor          # f32 [P] the pair's static gaussian weight
    rows: torch.Tensor       # int32 [R] output row of each plan row, ascending
    view_ptr: torch.Tensor   # int32 [V+1] plan rows of view v: view_ptr[v]:view_ptr[v+1]
    launch_rows: torch.Tensor    # int32 [R, 4] the kernels' table of the rows
    num_points: int          # output rows (V·M)
    n_pixels: int
    view_rows: Tuple[int, ...]   # plan rows per view, on the host (K2's grid)

    @property
    def n_pairs(self) -> int:
        return int(self.pix.numel())

    @property
    def n_rows(self) -> int:
        return int(self.row_ptr.numel()) - 1

    @property
    def n_views(self) -> int:
        return len(self.view_rows)

    @property
    def device(self) -> torch.device:
        return self.pix.device

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.row_ptr, self.pix, self.w, self.rows, self.view_ptr,
                self.launch_rows)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "CsrPlan":
        """The same plan with fn applied to each of its tensors."""
        return dataclasses.replace(
            self, row_ptr=fn(self.row_ptr), pix=fn(self.pix), w=fn(self.w),
            rows=fn(self.rows), view_ptr=fn(self.view_ptr),
            launch_rows=fn(self.launch_rows))

    def to(self, device, non_blocking: bool = False) -> "CsrPlan":
        return self.map(lambda t: t.to(device, non_blocking=non_blocking))

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


def _kept_pairs(idx, weights, num_points, pair_mask):
    """(point id, pixel row, weight) of every kept pair, in pair order."""
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
    return flat, pix, w


def launch_rows_of(row_ptr: torch.Tensor, rows: torch.Tensor,
                   view_ptr: torch.Tensor) -> torch.Tensor:
    """int32 [R, 4]: each plan row r as (row_ptr[r], row_ptr[r+1], rows[r],
    its view), so that a kernel starts a row with one 16-byte load,
    coalesced across rows."""
    view = torch.repeat_interleave(
        torch.arange(view_ptr.numel() - 1, device=rows.device,
                     dtype=torch.int32),
        torch.diff(view_ptr).to(torch.int64))
    return torch.stack([row_ptr[:-1], row_ptr[1:], rows, view],
                       1).contiguous()


def build_batched_csr_plan(
    idx: torch.Tensor,                       # [V, ..., k] per-view point ids
    weights: torch.Tensor,                   # [V, ..., k]
    num_points: int,                         # M, points per view
    pair_mask: Optional[torch.Tensor] = None,  # bool, broadcastable to idx
) -> CsrPlan:
    """Combined plan for per-view point copies (splat_gather_batched, the
    DeepFool engine): view v's pairs address output rows v·M + m of a
    [V·M, C] result. Only the rows some kept pair touches get a plan row.
    False pairs of `pair_mask` are dropped (background pixels, whose
    gradient is identically zero). The kernels walk the rows in plan-row
    order, as `launch_rows` lists them.

    The counterpart of the JAX package's `build_batched_scatter_plan`,
    without its padding of M to a multiple of 512, which only the TPU's
    chunk layout needs."""
    V = idx.shape[0]
    if V * num_points >= 2 ** 31:
        raise ValueError("V·M must fit int32")
    n_pix_view = idx[0, ..., 0].numel()
    flat, pix, w = _kept_pairs(idx, weights, num_points, pair_mask)
    out_row = flat.to(torch.int64) + (pix // n_pix_view) * num_points
    sorted_rows, order = torch.sort(out_row, stable=True)
    rows, counts = torch.unique_consecutive(sorted_rows, return_counts=True)
    dev = idx.device
    row_ptr = torch.zeros(rows.numel() + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    starts = torch.arange(V + 1, device=dev, dtype=torch.int64) * num_points
    view_ptr = torch.searchsorted(rows, starts).to(torch.int32)
    pix = pix[order].to(torch.int32)
    rows = rows.to(torch.int32)
    return CsrPlan(
        row_ptr=row_ptr,
        pix=pix,
        w=w[order].contiguous(),
        num_points=V * num_points,
        n_pixels=idx.numel() // idx.shape[-1],
        rows=rows,
        view_ptr=view_ptr,
        launch_rows=launch_rows_of(row_ptr, rows, view_ptr),
        view_rows=tuple(torch.diff(view_ptr).tolist()),
    )


def build_csr_plan(
    idx: torch.Tensor,                       # [..., k] point ids
    weights: torch.Tensor,                   # [..., k]
    num_points: int,
    pair_mask: Optional[torch.Tensor] = None,  # bool, broadcastable to idx
) -> CsrPlan:
    """The plan of one table batch over a point set that all its pixels
    share (the splat backward of NeRFail-S): the batched plan with one
    view."""
    return build_batched_csr_plan(
        idx[None], weights[None], num_points,
        None if pair_mask is None else pair_mask[None])


def plan_point_ids(plan: CsrPlan) -> torch.Tensor:
    """int64 [P] output row of every pair (expands row_ptr)."""
    counts = (plan.row_ptr[1:] - plan.row_ptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(plan.rows.to(torch.int64), counts)


def segment_sum_plain(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """The plain PyTorch version of K1: index_add_ of w·g[pix] in fp32."""
    contrib = plan.w[:, None] * g[plan.pix.to(torch.int64)]
    out = torch.zeros(plan.num_points, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, plan_point_ids(plan), contrib)


def class_rows(stack: torch.Tensor, cls: torch.Tensor, plan: CsrPlan,
               channels: int) -> torch.Tensor:
    """[n_pixels, C]: view v's pixels' channels cls[v]·C .. cls[v]·C + C − 1
    of the pixel-major class stack [n_pixels, ncls·C] (a copy)."""
    V = plan.n_views
    n_classes = stack.shape[1] // channels
    views = torch.arange(V, device=stack.device)
    return stack.reshape(V, -1, n_classes, channels)[
        views, :, cls.to(stack.device).long()].reshape(-1, channels)


def segment_sum_class_plain(stack: torch.Tensor, cls: torch.Tensor,
                            plan: CsrPlan, channels: int = 4) -> torch.Tensor:
    """The plain version of K1's in-place pick: each view's class gathered
    out of the stack, then `segment_sum_plain`."""
    return segment_sum_plain(class_rows(stack, cls, plan, channels), plan)


def error_bound(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """[M, C] bound on |kernel − plain| of K1: both sum the same rounded
    products of a point's n pairs, in two orders, so each is within
    (n−1)·u·Σ|w·g| of the exact sum (u = 2⁻²⁴); the bound adds one more
    u·Σ|w·g| for rounding in Σ|w·g| itself."""
    n = torch.zeros(plan.num_points, device=g.device).index_copy_(
        0, plan.rows.to(torch.int64),
        (plan.row_ptr[1:] - plan.row_ptr[:-1]).to(torch.float32))
    abs_plan = dataclasses.replace(plan, w=plan.w.abs())
    return (2 * n[:, None] + 1) * U32 * segment_sum_plain(g.abs(), abs_plan)


def segment_sq_plain(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """The plain PyTorch version of K2: segment_sum_plain, then square,
    then sum per view → [V, C]. The squares and their sum are taken in
    float64 and rounded once, so the plain side adds one rounding to what
    `sq_error_bound` allows the kernel."""
    s = segment_sum_plain(g, plan).to(torch.float64)
    V = plan.n_views
    return (s * s).view(V, -1, g.shape[1]).sum(1).to(torch.float32)


def _sq_tree_depth(plan: CsrPlan) -> int:
    """Most additions any squared row passes through in K2: a lane's rows,
    the block's lane groups, one strided run of the view's partials, then
    the sum of the runs."""
    return (SQ_ROWS_PER_GROUP + SQ_GROUPS
            + -(-_sq_chunks(plan) // SQ_FIN) + SQ_FIN)


def sq_error_bound(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """[V, C] bound on |K2 − segment_sq_plain|, derived from K1's
    `error_bound` E per row: with a the plain row sum and b the kernel's,
    |b² − a²| ≤ E·(2|a| + E); K2 then rounds each square and adds the
    nonnegative squares through a tree of depth d (`_sq_tree_depth`), so it
    is within (d+1)·u·Σb² of Σb², and the plain side rounds once more.
    Taken in float64, with b² ≤ (|a| + E)², and rounded up by 0.1 %."""
    V, C = plan.n_views, g.shape[1]
    a = segment_sum_plain(g, plan).to(torch.float64).abs().view(V, -1, C)
    E = error_bound(g, plan).to(torch.float64).view(V, -1, C)
    rows = (E * (2 * a + E)).sum(1)
    sums = (_sq_tree_depth(plan) + 2) * U32 * ((a + E) ** 2).sum(1)
    return ((rows + sums) * 1.001).to(torch.float32)


def _check_plan(plan: CsrPlan, device: torch.device, what: str) -> None:
    named = [("row_ptr", plan.row_ptr, torch.int32),
             ("pix", plan.pix, torch.int32),
             ("w", plan.w, torch.float32),
             ("rows", plan.rows, torch.int32),
             ("view_ptr", plan.view_ptr, torch.int32),
             ("launch_rows", plan.launch_rows, torch.int32)]
    for name, t, dt in named:
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{what}: plan.{name} must be contiguous {dt} on "
                f"{device}, got {t.dtype} on {t.device}"
            )
    if (plan.launch_rows.shape != (plan.n_rows, 4)
            or plan.launch_rows.data_ptr() % 16):
        raise ValueError(f"{what}: plan.launch_rows must list the "
                         f"{plan.n_rows} plan rows, 16-byte aligned")


def _on_cpu(g: torch.Tensor, plan: CsrPlan, what: str) -> bool:
    """Checks shared by the wrappers; True if g lies on the CPU (the plain
    version runs), else g is a contiguous f32 matrix on the card and the
    plan is fit for the kernels."""
    if g.ndim != 2:
        raise ValueError(f"g must be [n_pixels, C], got {tuple(g.shape)}")
    if g.shape[0] != plan.n_pixels:
        raise ValueError(
            f"plan was built for {plan.n_pixels} pixels, g has {g.shape[0]}"
        )
    if g.device.type == "cpu":
        return True
    if g.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {g.device}")
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"{what}: g must be contiguous float32")
    _check_plan(plan, g.device, what)
    return False


def _check_g(g: torch.Tensor, plan: CsrPlan, what: str) -> bool:
    """`_on_cpu`, and on the card 1 ≤ C ≤ MAX_CHANNELS."""
    if _on_cpu(g, plan, what):
        return True
    if not 1 <= g.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"{what}: C={g.shape[1]} outside 1..{MAX_CHANNELS}")
    return False


def _launcher():
    fn = build.load("segsum").segsum_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _k1(g: torch.Tensor, plan: CsrPlan, C: int, cls: Optional[torch.Tensor],
        what: str) -> torch.Tensor:
    """One K1 launch over g's rows (stride g.shape[1]), reading channels
    cls[v]·C onwards of a row of view v when cls is given."""
    # the kernel writes only the plan's rows: the others are zero
    out = torch.zeros(plan.num_points, C, dtype=torch.float32,
                      device=g.device)
    if C == 4 and (g.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError(f"{what}: C=4 rows must be 16-byte aligned")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _launcher()(
            plan.launch_rows.data_ptr(), plan.pix.data_ptr(),
            plan.w.data_ptr(), g.data_ptr(),
            None if cls is None else cls.data_ptr(), out.data_ptr(),
            plan.n_rows, C, g.shape[1], stream,
        )
    build.check(status, "segsum_launch")
    segment_sum.launches += 1
    return out


def segment_sum(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """d_points [num_points, C] = Σ_pairs w·g[pix] grouped by output row.

    g [n_pixels, C] f32. CUDA tensors launch K1 (and count the launch in
    `segment_sum.launches`); CPU tensors take the plain version."""
    if _check_g(g, plan, "segment_sum"):
        return segment_sum_plain(g, plan)
    return _k1(g, plan, g.shape[1], None, "segment_sum")


segment_sum.launches = 0


def segment_sum_class(stack: torch.Tensor, cls: torch.Tensor, plan: CsrPlan,
                      channels: int = 4) -> torch.Tensor:
    """K1 on one class per view of a pixel-major class stack, read in place:
    d_points [num_points, C] = Σ_pairs w·stack[pix, cls[v]·C : cls[v]·C+C]
    for the rows of view v (the DeepFool engine's pick).

    stack [n_pixels, ncls·C] f32, cls [V] integer class per view. CUDA
    stacks launch K1 (counted in `segment_sum.launches`); CPU stacks take
    `segment_sum_class_plain`. A class tensor on the CPU is range-checked
    here and copied to the card. One already on the card is not read back:
    the kernel checks each view's class and stops with a device fault
    (reported by the next synchronising call, and fatal to the CUDA
    context) on a class outside 0..ncls−1."""
    what = "segment_sum_class"
    C = channels
    if stack.ndim != 2 or not 1 <= C <= MAX_CHANNELS or stack.shape[1] % C:
        raise ValueError(f"{what}: stack {tuple(stack.shape)} is not "
                         f"[n_pixels, ncls·{C}] with 1 ≤ C ≤ {MAX_CHANNELS}")
    n_classes = stack.shape[1] // C
    if (cls.shape != (plan.n_views,) or cls.dtype.is_floating_point
            or cls.dtype.is_complex or cls.dtype == torch.bool):
        raise ValueError(f"{what}: cls must be an integer [{plan.n_views}] "
                         f"tensor, got {cls.dtype} {tuple(cls.shape)}")
    if cls.device.type == "cpu" and cls.numel() and not (
            0 <= int(cls.min()) and int(cls.max()) < n_classes):
        raise ValueError(f"{what}: classes {cls.tolist()} outside "
                         f"0..{n_classes - 1}")
    if _on_cpu(stack, plan, what):
        return segment_sum_class_plain(stack, cls, plan, C)
    if cls.device.type not in ("cpu", stack.device.type) or (
            cls.device.type == "cuda" and cls.device != stack.device):
        raise ValueError(f"{what}: cls on {cls.device}, stack on "
                         f"{stack.device}")
    cls = cls.to(stack.device, torch.int32).contiguous()
    return _k1(stack, plan, C, cls, what)


def _sq_chunks(plan: CsrPlan) -> int:
    """Blocks per view of K2."""
    return max(1, -(-max(plan.view_rows, default=0) // SQ_ROWS_PER_BLOCK))


def _sq_launcher():
    fn = build.load("segsum_sq").segsum_sq_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """K2's per-view ticket counters on this stream, one 128-byte line
    each: zero between launches (each view's last block resets its own)."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < SQ_TICKET_STRIDE * n:
        t = torch.zeros(SQ_TICKET_STRIDE * max(n, 8), dtype=torch.int32,
                        device=device)
        _TICKETS[(device, stream)] = t
    return t


def segment_sq(g: torch.Tensor, plan: CsrPlan) -> torch.Tensor:
    """sq [V, C] = Σ over view v's rows of (Σ_pairs w·g[pix])², per channel,
    without writing the row sums.

    g [n_pixels, C] f32. CUDA tensors launch K2 (and count the launch in
    `segment_sq.launches`); CPU tensors take the plain version."""
    if _check_g(g, plan, "segment_sq"):
        return segment_sq_plain(g, plan)
    C, V = g.shape[1], plan.n_views
    if C in (4, 8, 16, 32) and g.data_ptr() % 16:
        raise ValueError(f"segment_sq: C={C} rows must be 16-byte aligned")
    n_chunks = _sq_chunks(plan)
    partial = torch.empty(V, n_chunks, C, dtype=torch.float32,
                          device=g.device)
    out = torch.empty(V, C, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _tickets(g.device, stream, V)
        status = _sq_launcher()(
            plan.launch_rows.data_ptr(), plan.view_ptr.data_ptr(),
            plan.pix.data_ptr(), plan.w.data_ptr(), g.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), out.data_ptr(), V,
            n_chunks, C, stream,
        )
    build.check(status, "segsum_sq_launch")
    segment_sq.launches += 1
    return out


segment_sq.launches = 0
