"""K3: exact k-NN over pruned candidate tiles, as CUDA kernels.

Replaces nerfail_tpu/ops/pallas/knn_kernel.py `_knn_kernel` (via
`_knn_call` and `knn_pallas`). The table build needs, for every pixel of
every view, the 8 nearest points of the point set S: 640K queries ×
1.92M points per 800² view, far too many pairs to stage distances in
memory.

The plan is the JAX package's host numpy (`_morton_order`,
`_candidates`), computed here in torch ops on the prep's device: both
sides are sorted along a Morton curve so consecutive tiles are compact,
and a query tile keeps only the point tiles whose bounding-box lower
bound can beat an upper bound on its 8th-NN distance (exact pruning).
The candidate table is a CSR (`row_ptr`, `tiles`), each row ordered by
the lower bound, ties by tile id. What the TPU needed on top of that
goes: no scalar-prefetch budget, no width bucketing, no segmented passes.

The rows are very uneven (an 800² view: median 67 candidate tiles, the
largest 3709, where a query tile's Morton range straddles a jump of the
curve). So the search cuts each row into work items of at most
`ITEM_TILES` consecutive candidate tiles, one block each, and a second
kernel merges the partial top-8s of a split row in item order; the merge
is stable, so the result is bit-equal to one scan of the row
(`csrc/knn.cu` gives the argument). Both are bound by fp32 arithmetic
outside the tensor cores: 8 rounded operations per (query, candidate
point) pair, so the pruning, which sets the pair count, sets the time.

`knn` launches the kernels when the prepared points lie on a CUDA device
and runs `knn_sq_plain`, a streaming brute-force top-k with the same
(q − p)² arithmetic, when they lie on the CPU. `knn_sq_planned_plain`
walks a plan in items and merges them as the kernels do: the CPU oracle
of the split.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from nerfail_tpu_torch.ops.cuda import build
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

# tile sizes compiled into csrc/knn.cu
KERNEL_TQ = 256
KERNEL_TP = 512
# candidate tiles per work item of the search, chosen on the card
# (PERF.md, Findings: 32, 64 and 128 within 3 %, 64 the fastest)
ITEM_TILES = 64
# elements of the [query tiles, point tiles] bound matrices per pass
PLAN_BLOCK = 1 << 24


# ------------------------------------------------------------------- the plan


def _as_points(x, device: torch.device) -> torch.Tensor:
    """[..., 3] numpy or tensor → contiguous f32 [N, 3] on `device`."""
    return torch.as_tensor(x, dtype=torch.float32, device=device) \
        .reshape(-1, 3).contiguous()


def _morton_order(x: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Permutation sorting 3D points along a Morton (Z-order) curve, so
    consecutive tiles are spatially compact and bbox pruning bites. The
    JAX package's arithmetic, op for op, and a stable sort."""
    lo, hi = x.amin(0), x.amax(0)
    q = ((x - lo) / torch.clamp(hi - lo, min=1e-12) * (2 ** bits - 1)).to(
        torch.int64)

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.argsort(code, stable=True)


def _tile_bboxes(x: torch.Tensor, tile: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    t = x[: x.shape[0] // tile * tile].reshape(-1, tile, 3)
    return t.amin(1), t.amax(1)


def _sq3(v: torch.Tensor) -> torch.Tensor:
    """(v₀² + v₁²) + v₂², each op rounded (numpy's einsum order)."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) \
        + v[..., 2] * v[..., 2]


def _candidates(q_lo, q_hi, p_lo, p_hi, n_full_p: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact bbox pruning: per query tile, the point tiles that can hold
    one of its nearest neighbours, by lower bound ascending, ties by tile
    id. Returns the CSR (row_ptr int32 [n_q + 1], tiles int32), in row
    blocks of at most PLAN_BLOCK bound entries."""
    n_q, n_p = q_lo.shape[0], p_lo.shape[0]
    rows = max(1, PLAN_BLOCK // n_p)
    counts, tiles = [], []
    for r0 in range(0, n_q, rows):
        ql, qh = q_lo[r0:r0 + rows, None, :], q_hi[r0:r0 + rows, None, :]
        # lower bound between boxes, per dim: gap = max(0, plo-qhi, qlo-phi)
        lb2 = _sq3(torch.clamp(torch.maximum(p_lo - qh, ql - p_hi), min=0.0))
        # upper bound: farthest corner distance, per dim the larger overhang
        ub2 = _sq3(torch.maximum((p_hi - ql).abs(), (qh - p_lo).abs()))
        # τ²: the k-th NN of every query in the tile is ≤ the best full
        # tile's max-corner distance (a full tile holds tp ≥ k points)
        tau2 = (ub2[:, :n_full_p] if n_full_p else ub2).amin(1)
        keep = lb2 <= (tau2 + 1e-12)[:, None]
        r, t = keep.nonzero(as_tuple=True)          # row-major: t ascending
        # lb² ≥ +0, so its bits order as the values; a stable sort on
        # (row, lb² bits) leaves ties in tile order
        key = (r << 32) | lb2[r, t].view(torch.int32).to(torch.int64)
        tiles.append(t[torch.argsort(key, stable=True)].to(torch.int32))
        counts.append(keep.sum(1))
    row_ptr = torch.zeros(n_q + 1, dtype=torch.int64, device=q_lo.device)
    row_ptr[1:] = torch.cumsum(torch.cat(counts), 0)
    return row_ptr.to(torch.int32), torch.cat(tiles)


class KnnPrep:
    """Point-side preparation, built once per point set and reused for
    every view's query sweep, on `device`: the Morton permutation
    `pperm`, the points in that order as [Mp, 4] f32 rows (x, y, z, 0)
    padded to whole tiles with far points that the kernel skips, and the
    tile bboxes."""

    def __init__(self, points, tp: int = KERNEL_TP, prune: bool = True,
                 device: DeviceLike = "cuda"):
        dev = self.device = resolve_device(device)
        points = _as_points(points, dev)
        M = points.shape[0]
        self.M, self.tp, self.prune = M, tp, prune
        self.pperm = (_morton_order(points) if prune
                      else torch.arange(M, device=dev))
        ps = points[self.pperm]
        Mp = self.Mp = -(-M // tp) * tp
        self.ppk = torch.zeros(Mp, 4, dtype=torch.float32, device=dev)
        self.ppk[:M, :3] = ps
        self.ppk[M:, :3] = 1e30
        self.n_p = Mp // tp
        self.n_full_p = self.n_p if M == Mp else self.n_p - 1
        if prune and self.n_p > 1:
            self.p_lo, self.p_hi = _tile_bboxes(
                torch.cat([ps, ps[-1:].expand(Mp - M, 3)]), tp)
        else:
            self.p_lo = self.p_hi = None


@dataclass
class KnnWork:
    """The search's work items for one plan, built on the plan's device.

    `items` int32 [n_items, 4]: (query tile, first slot in `tiles`, tile
    count, scratch slot), largest first; the scratch slot is −1 for a
    row's only item, which writes the output itself. `merges` int32
    [n_merges, 3]: (query tile, first scratch slot, items) for every row
    cut into several items, whose slots follow the row's scan order."""

    items: torch.Tensor
    merges: torch.Tensor
    n_rows: int
    n_scratch: int
    item_tiles: int


class KnnQueryPlan:
    """The query plan for one sweep, on the prep's device: Morton order of
    the queries (`qperm`), the padded query tiles (`qpk`, [n_q·tq, 3]) and
    the candidate table as a CSR (`row_ptr` [n_q + 1], `tiles`)."""

    def __init__(self, queries, prep: KnnPrep, k: int = 8,
                 tq: int = KERNEL_TQ):
        dev = prep.device
        queries = _as_points(queries, dev)
        self.prep, self.k, self.tq = prep, k, tq
        Q = self.Q = queries.shape[0]
        self.qperm = (_morton_order(queries) if prep.prune
                      else torch.arange(Q, device=dev))
        qs = queries[self.qperm]
        Qp = -(-Q // tq) * tq
        # pad with the last real query (harmless duplicate work)
        self.qpk = torch.cat([qs, qs[-1:].expand(Qp - Q, 3)]).contiguous()
        n_q = self.n_q = Qp // tq
        if prep.prune and prep.n_p > 1:
            q_lo, q_hi = _tile_bboxes(self.qpk, tq)
            self.row_ptr, self.tiles = _candidates(
                q_lo, q_hi, prep.p_lo, prep.p_hi, prep.n_full_p)
        else:
            n_p = prep.n_p
            self.row_ptr = (torch.arange(n_q + 1, device=dev) * n_p).to(
                torch.int32)
            self.tiles = torch.arange(n_p, dtype=torch.int32,
                                      device=dev).repeat(n_q)

    def max_c(self) -> int:
        """Candidate tiles of the longest row."""
        return int((self.row_ptr[1:] - self.row_ptr[:-1]).max())

    def pair_count(self) -> int:
        """(query, candidate point) pairs the search evaluates: every
        padded query against every real point of its tile's candidate
        tiles."""
        tp, M = self.prep.tp, self.prep.M
        real = torch.clamp(M - self.tiles.long() * tp, max=tp)
        return int(real.sum()) * self.tq

    def work(self, item_tiles: int = ITEM_TILES) -> KnnWork:
        """Cut every CSR row into work items of at most `item_tiles`
        consecutive candidate tiles (an empty row still gets one, which
        writes inf)."""
        dev = self.row_ptr.device
        rp = self.row_ptr.long()
        counts = rp[1:] - rp[:-1]
        nit = torch.clamp(-(-counts // item_tiles), min=1)
        n_items = int(nit.sum())
        row = torch.repeat_interleave(torch.arange(self.n_q, device=dev), nit,
                                      output_size=n_items)
        start = torch.cumsum(nit, 0) - nit          # each row's first item
        first = rp[row] + (torch.arange(n_items, device=dev) - start[row]) \
            * item_tiles
        count = torch.clamp(rp[row + 1] - first, max=item_tiles)
        multi = nit[row] > 1
        slot = torch.where(multi, torch.cumsum(multi, 0) - 1, -1)
        items = torch.stack([row, first, count, slot], 1)
        items = items[torch.argsort(-count, stable=True)]
        mrows = torch.nonzero(nit > 1).squeeze(1)
        merges = torch.stack([mrows, slot[start[mrows]], nit[mrows]], 1)
        return KnnWork(items.to(torch.int32).contiguous(),
                       merges.to(torch.int32).contiguous(), self.n_q,
                       int(multi.sum()), item_tiles)


# --------------------------------------------------------------- the search


def _sq_dist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[nq, 3] × [n, 3] → [nq, n] d² = (dx² + dy²) + dz², each op
    rounded: the kernel's arithmetic."""
    dx = q[:, None, 0] - p[None, :, 0]
    d2 = dx * dx
    dy = q[:, None, 1] - p[None, :, 1]
    d2 = d2 + dy * dy
    dz = q[:, None, 2] - p[None, :, 2]
    return d2 + dz * dz


def _keep_k(best_d, best_i, d2, ids, k):
    """The first k of a stable sort of [kept, new] by d²: the kernel's
    strict-`<` insert, new entries after every kept entry ≤ them."""
    vals, pos = torch.sort(torch.cat([best_d, d2], 1), dim=1, stable=True)
    return vals[:, :k], torch.cat([best_i, ids], 1).gather(1, pos[:, :k])


def knn_sq_plain(q: torch.Tensor, p: torch.Tensor, k: int = 8,
                 q_chunk: int = 4096, p_tile: int = 16384
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: streaming brute-force top-k.

    q [Q, 3], p [M, 3] on one device → (squared distance [Q, k] f32,
    index [Q, k] int64), ascending. d² = (dx² + dy²) + dz² in separate
    rounded ops, the kernel's arithmetic. Ties keep the lower index (a
    stable sort of kept-then-new)."""
    Q, M = q.shape[0], p.shape[0]
    out_d = torch.empty(Q, k, dtype=torch.float32, device=q.device)
    out_i = torch.empty(Q, k, dtype=torch.int64, device=q.device)
    for qs in range(0, Q, q_chunk):
        qc = q[qs:qs + q_chunk]
        nq = qc.shape[0]
        best_d = torch.full((nq, k), float("inf"), device=q.device)
        best_i = torch.zeros(nq, k, dtype=torch.int64, device=q.device)
        for ps in range(0, M, p_tile):
            pc = p[ps:ps + p_tile]
            ids = torch.arange(ps, ps + pc.shape[0], device=q.device)
            best_d, best_i = _keep_k(best_d, best_i, _sq_dist(qc, pc),
                                     ids.expand(nq, -1), k)
        out_d[qs:qs + nq] = best_d
        out_i[qs:qs + nq] = best_i
    return out_d, out_i


def knn_sq_planned_plain(qpk: torch.Tensor, ppk: torch.Tensor,
                         plan: KnnQueryPlan, item_tiles: int = ITEM_TILES
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split search in plain PyTorch: every CSR row of `plan` scanned
    in items of `item_tiles` candidate tiles, each item's top-k from
    (inf, 0), then the items' lists merged stably in scan order. The CPU
    oracle of the kernels' split; bit-equal to one scan of each row.
    qpk [n_q·tq, 3], ppk [Mp, 4] → (d² [n_q·tq, k] f32, Morton-order
    index [·, k] int64)."""
    tq, tp, M, k = plan.tq, plan.prep.tp, plan.prep.M, plan.k
    dev = qpk.device
    row_ptr, tiles = plan.row_ptr.tolist(), plan.tiles.tolist()
    out_d = torch.empty(plan.n_q * tq, k, dtype=torch.float32, device=dev)
    out_i = torch.empty(plan.n_q * tq, k, dtype=torch.int64, device=dev)
    inf = torch.full((tq, k), float("inf"), device=dev)
    zero = torch.zeros(tq, k, dtype=torch.int64, device=dev)
    for r in range(plan.n_q):
        q = qpk[r * tq:(r + 1) * tq]
        best_d, best_i = inf, zero
        for s in range(row_ptr[r], row_ptr[r + 1], item_tiles):
            ids = torch.cat([
                torch.arange(t * tp, min(t * tp + tp, M), device=dev)
                for t in tiles[s:min(s + item_tiles, row_ptr[r + 1])]])
            d, i = _keep_k(inf, zero, _sq_dist(q, ppk[ids, :3]),
                           ids.expand(tq, -1), k)
            best_d, best_i = _keep_k(best_d, best_i, d, i, k)
        out_d[r * tq:(r + 1) * tq] = best_d
        out_i[r * tq:(r + 1) * tq] = best_i
    return out_d, out_i


def knn_plain(queries: torch.Tensor, points: torch.Tensor, k: int = 8,
              q_chunk: int = 4096, p_tile: int = 16384
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean k-NN (dist [Q, k] ascending, global idx int64 [Q, k])."""
    d2, idx = knn_sq_plain(queries, points, k, q_chunk, p_tile)
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx


def _lib():
    lib = build.load("knn")
    lib.knn_search_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
        * 2 + [ctypes.c_void_p] * 5
    lib.knn_merge_launch.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 5
    lib.knn_search_launch.restype = lib.knn_merge_launch.restype = \
        ctypes.c_int
    return lib


@dataclass
class K3Launch:
    """K3's buffers for one sweep and its two kernels: `search` (one block
    per work item: a row's only item writes the output, the others a
    partial top-8 each to scratch) and `merge` (the split rows' partial
    lists, stably in item order). `knn_sq_cuda` runs both. Each counts
    its launches on `knn_sq_cuda`."""

    qpk: torch.Tensor
    ppk: torch.Tensor
    tiles: torch.Tensor
    work: KnnWork
    m_total: int
    out_d: torch.Tensor
    out_i: torch.Tensor
    part_d: torch.Tensor
    part_i: torch.Tensor

    @staticmethod
    def prepare(qpk: torch.Tensor, ppk: torch.Tensor, tiles: torch.Tensor,
                work: KnnWork, m_total: int) -> "K3Launch":
        dev = qpk.device
        if dev.type != "cuda":
            raise ValueError(f"knn_sq_cuda: tensors must be on CUDA, got {dev}")
        n_q, Mp = work.n_rows, ppk.shape[0]
        for name, t, dt, shape in (
            ("qpk", qpk, torch.float32, (n_q * KERNEL_TQ, 3)),
            ("ppk", ppk, torch.float32, (Mp, 4)),
            ("tiles", tiles, torch.int32, (tiles.numel(),)),
            ("items", work.items, torch.int32, (work.items.shape[0], 4)),
            ("merges", work.merges, torch.int32, (work.merges.shape[0], 3)),
        ):
            if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                    or tuple(t.shape) != shape):
                raise ValueError(
                    f"knn_sq_cuda: {name} must be contiguous {dt} {shape} on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if Mp % KERNEL_TP or not 0 < m_total <= Mp:
            raise ValueError(f"knn_sq_cuda: bad point padding Mp={Mp}, "
                             f"M={m_total} (tile {KERNEL_TP})")
        S = work.n_scratch
        return K3Launch(
            qpk, ppk, tiles, work, m_total,
            torch.empty(n_q * KERNEL_TQ, 8, dtype=torch.float32, device=dev),
            torch.empty(n_q * KERNEL_TQ, 8, dtype=torch.int32, device=dev),
            torch.empty(S * KERNEL_TQ, 8, dtype=torch.float32, device=dev),
            torch.empty(S * KERNEL_TQ, 8, dtype=torch.int32, device=dev))

    def search(self) -> None:
        with torch.cuda.device(self.qpk.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().knn_search_launch(
                self.qpk.data_ptr(), self.ppk.data_ptr(),
                self.tiles.data_ptr(), self.work.items.data_ptr(),
                self.work.items.shape[0], self.m_total, self.out_d.data_ptr(),
                self.out_i.data_ptr(), self.part_d.data_ptr(),
                self.part_i.data_ptr(), stream)
        build.check(status, "knn_search_launch")
        knn_sq_cuda.launches += 1

    def merge(self) -> None:
        """No launch when no row was split."""
        if not self.work.merges.shape[0]:
            return
        with torch.cuda.device(self.qpk.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().knn_merge_launch(
                self.work.merges.data_ptr(), self.work.merges.shape[0],
                self.part_d.data_ptr(), self.part_i.data_ptr(),
                self.out_d.data_ptr(), self.out_i.data_ptr(), stream)
        build.check(status, "knn_merge_launch")
        knn_sq_cuda.merge_launches += 1


def knn_sq_cuda(qpk: torch.Tensor, ppk: torch.Tensor, tiles: torch.Tensor,
                work: KnnWork, m_total: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the search and, if a row was split, the merge: qpk
    [n_q·256, 3], ppk [Mp, 4], the plan's `tiles` and its work items →
    (d² [n_q·256, 8] f32, Morton-order idx [·, 8] int32). Counts the
    launches in `knn_sq_cuda.launches` (search) and
    `knn_sq_cuda.merge_launches`."""
    k3 = K3Launch.prepare(qpk, ppk, tiles, work, m_total)
    k3.search()
    k3.merge()
    return k3.out_d, k3.out_i


knn_sq_cuda.launches = 0
knn_sq_cuda.merge_launches = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def knn(
    queries=None,                      # [Q, 3] numpy or tensor
    points=None,                       # [M, 3]
    k: Optional[int] = None,
    tq: int = KERNEL_TQ,
    tp: int = KERNEL_TP,
    prune: bool = True,
    prep: Optional[KnnPrep] = None,
    plan: Optional[KnnQueryPlan] = None,
    device: DeviceLike = "cuda",
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of each query in the point set: (dist [Q, k] f32
    ascending, global idx [Q, k] int32), on the prep's device.

    Give `queries` with `points` or a reusable `prep`, or a prebuilt
    `plan` alone: a plan already fixes the queries, the point set and k,
    so combining it with any of them raises. With a `timings` dict the
    call synchronises the device after the plan and at its end, and adds
    the wall seconds of the plan under "plan" and of the rest (work
    items, search, merge, un-permutation) under "search"."""
    t0 = time.perf_counter()
    if plan is not None:
        if queries is not None or points is not None or prep is not None \
                or k is not None:
            raise ValueError("pass `plan` alone: it already fixes the "
                             "queries, the point set and k")
    else:
        if queries is None:
            raise ValueError("knn needs `queries` or a `plan`")
        if prep is None:
            if points is None:
                raise ValueError("knn needs either `points` or a `prep`")
            prep = KnnPrep(points, tp=tp, prune=prune, device=device)
        elif points is not None:
            raise ValueError("pass `points` OR `prep`, not both — the prep "
                             "already owns a (possibly different) point set")
        plan = KnnQueryPlan(queries, prep, k=8 if k is None else k, tq=tq)
    prep, k = plan.prep, plan.k
    dev, M = prep.device, prep.M
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timings["plan"] = timings.get("plan", 0.0) + t1 - t0
    if dev.type == "cuda":
        if k != 8 or plan.tq != KERNEL_TQ or prep.tp != KERNEL_TP:
            raise ValueError(
                f"the CUDA kernel is built for k=8, tq={KERNEL_TQ}, "
                f"tp={KERNEL_TP}; got k={k}, tq={plan.tq}, tp={prep.tp}"
            )
        d2, idx = knn_sq_cuda(plan.qpk, prep.ppk, plan.tiles, plan.work(), M)
    else:
        d2, idx = knn_sq_plain(plan.qpk, prep.ppk[:M, :3], k)
    d = torch.sqrt(torch.clamp(d2[:plan.Q], min=0.0))
    # undo both permutations
    gidx = prep.pperm[torch.clamp(idx[:plan.Q].long(), max=M - 1)]
    out_d = torch.empty_like(d)
    out_i = torch.empty(gidx.shape, dtype=torch.int32, device=dev)
    out_d[plan.qperm] = d
    out_i[plan.qperm] = gidx.to(torch.int32)
    if timings is not None:
        _sync(dev)
        timings["search"] = timings.get("search", 0.0) \
            + time.perf_counter() - t1
    return out_d, out_i
