"""K3: exact k-NN over host-pruned candidate tiles, as a CUDA kernel.

Replaces nerfail_tpu/ops/pallas/knn_kernel.py `_knn_kernel` (via
`_knn_call` and `knn_pallas`). The table build needs, for every pixel of
every view, the 8 nearest points of the point set S: 640K queries ×
1.92M points per 800² view, far too many pairs to stage distances in
memory.

The host half is the JAX package's, in numpy: both sides are sorted along
a Morton curve so consecutive tiles are compact, and a query tile keeps
only the point tiles whose bounding-box lower bound can beat an upper
bound on its 8th-NN distance (exact pruning). What the TPU needed on top
of that goes: the candidate table is read from device memory, so there is
no scalar-prefetch budget, no width bucketing and no segmented passes.

The kernel (`csrc/knn.cu`) runs one block per query tile and one thread
per query, stages each candidate point tile in shared memory, and keeps
the running top-8 in registers. It is bound by fp32 arithmetic outside
the tensor cores (about 8 operations per query × candidate pair), so the
pruning, which sets the pair count, is what sets its time.

`knn` launches the kernel when the prepared points lie on a CUDA device
and runs `knn_sq_plain`, a streaming brute-force top-k with the same
(q − p)² arithmetic, when they lie on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from nerfail_tpu_torch.ops.cuda import build
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

# tile sizes compiled into csrc/knn.cu
KERNEL_TQ = 256
KERNEL_TP = 512


# ----------------------------------------------------------------- host side


def _morton_order(x: np.ndarray, bits: int = 10) -> np.ndarray:
    """Permutation sorting 3D points along a Morton (Z-order) curve, so
    consecutive tiles are spatially compact and bbox pruning bites."""
    lo, hi = x.min(0), x.max(0)
    q = ((x - lo) / np.maximum(hi - lo, 1e-12) * (2 ** bits - 1)).astype(
        np.uint64
    )

    def spread(v):
        v &= np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x30000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x9249249)
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def _tile_bboxes(x: np.ndarray, tile: int) -> Tuple[np.ndarray, np.ndarray]:
    n = x.shape[0] // tile
    t = x[: n * tile].reshape(n, tile, 3)
    return t.min(1), t.max(1)


def _candidates(q_lo, q_hi, p_lo, p_hi, n_full_p: int) -> np.ndarray:
    """Exact bbox pruning: per query tile, the point tiles that can hold
    one of its nearest neighbours, nearest lower bound first. Returns
    [n_q, max_c] int32, left-packed and padded with -1."""
    # lower bound between boxes, per dim: gap = max(0, plo-qhi, qlo-phi)
    q_lo = q_lo.astype(np.float32)[:, None, :]
    q_hi = q_hi.astype(np.float32)[:, None, :]
    p_lo = p_lo.astype(np.float32)[None, :, :]
    p_hi = p_hi.astype(np.float32)[None, :, :]
    gap = np.maximum(0.0, np.maximum(p_lo - q_hi, q_lo - p_hi))
    lb2 = np.einsum("qpd,qpd->qp", gap, gap)                   # [n_q, n_p]
    # upper bound: farthest corner distance, per dim the larger overhang
    span = np.maximum(np.abs(p_hi - q_lo), np.abs(q_hi - p_lo))
    ub2 = np.einsum("qpd,qpd->qp", span, span)
    # τ²: the k-th NN of every query in tile i is ≤ the best full tile's
    # max-corner distance (a full tile holds tp ≥ k points)
    full = ub2[:, :n_full_p] if n_full_p else ub2
    tau2 = full.min(1) if full.shape[1] else np.full(lb2.shape[0], np.inf)
    keep = lb2 <= tau2[:, None] + 1e-12
    counts = keep.sum(1)
    max_c = max(int(counts.max()), 1)
    order = np.argsort(np.where(keep, lb2, np.inf), axis=1)[:, :max_c]
    col = np.arange(max_c)[None, :]
    return np.where(col < counts[:, None], order, -1).astype(np.int32)


class KnnPrep:
    """Point-side preparation, built once per point set and reused for
    every view's query sweep: Morton sort, the [3, Mp] packed points on
    `device` (padded with far points that the kernel skips), tile bboxes."""

    def __init__(self, points, tp: int = KERNEL_TP, prune: bool = True,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        points = np.asarray(points, np.float32)
        M = points.shape[0]
        self.M, self.tp, self.prune = M, tp, prune
        self.pperm = _morton_order(points) if prune else np.arange(M)
        ps = points[self.pperm]
        Mp = -(-M // tp) * tp
        self.Mp = Mp
        ppad = np.concatenate([ps, np.full((Mp - M, 3), 1e30, np.float32)])
        self.ppk = torch.from_numpy(np.ascontiguousarray(ppad.T)).to(
            self.device)                                        # [3, Mp]
        self.pperm_t = torch.from_numpy(self.pperm.astype(np.int64)).to(
            self.device)
        self.n_p = Mp // tp
        self.n_full_p = self.n_p if M == Mp else self.n_p - 1
        if prune and self.n_p > 1:
            self.p_lo, self.p_hi = _tile_bboxes(
                np.concatenate([ps, np.repeat(ps[-1:], Mp - M, 0)]), tp
            )
        else:
            self.p_lo = self.p_hi = None


class KnnQueryPlan:
    """Host-side query plan for one sweep: Morton order of the queries,
    the padded query tiles and the candidate table. Pure numpy, so it can
    be built on a worker thread while the card runs the previous view."""

    def __init__(self, queries, prep: KnnPrep, k: int = 8,
                 tq: int = KERNEL_TQ):
        queries = np.asarray(queries, np.float32)
        self.prep, self.k, self.tq = prep, k, tq
        Q = self.Q = queries.shape[0]
        self.qperm = (_morton_order(queries) if prep.prune
                      else np.arange(Q))
        qs = queries[self.qperm]
        Qp = -(-Q // tq) * tq
        # pad with the last real query (harmless duplicate work)
        qpk = np.empty((Qp, 3), np.float32)
        qpk[:Q] = qs
        qpk[Q:] = qs[-1]
        self.qpk = qpk
        self.n_q = Qp // tq
        if prep.prune and prep.n_p > 1:
            q_lo, q_hi = _tile_bboxes(qpk, tq)
            self.cand = _candidates(q_lo, q_hi, prep.p_lo, prep.p_hi,
                                    prep.n_full_p)
        else:
            self.cand = np.tile(np.arange(prep.n_p, dtype=np.int32),
                                (self.n_q, 1))

    def pair_count(self) -> int:
        """(query, candidate point) pairs the kernel evaluates: every padded
        query against every real point of its tile's candidate tiles."""
        tp, M = self.prep.tp, self.prep.M
        c = self.cand[self.cand >= 0].astype(np.int64)
        return int(np.minimum(tp, M - c * tp).sum()) * self.tq


# --------------------------------------------------------------- the search


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
            dx = qc[:, None, 0] - pc[None, :, 0]
            d2 = dx * dx
            dy = qc[:, None, 1] - pc[None, :, 1]
            d2 = d2 + dy * dy
            dz = qc[:, None, 2] - pc[None, :, 2]
            d2 = d2 + dz * dz
            cd = torch.cat([best_d, d2], 1)
            ci = torch.cat([
                best_i,
                torch.arange(ps, ps + pc.shape[0], device=q.device)
                .expand(nq, -1),
            ], 1)
            vals, pos = torch.sort(cd, dim=1, stable=True)
            best_d = vals[:, :k]
            best_i = ci.gather(1, pos[:, :k])
        out_d[qs:qs + nq] = best_d
        out_i[qs:qs + nq] = best_i
    return out_d, out_i


def knn_plain(queries: torch.Tensor, points: torch.Tensor, k: int = 8,
              q_chunk: int = 4096, p_tile: int = 16384
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean k-NN (dist [Q, k] ascending, global idx int64 [Q, k])."""
    d2, idx = knn_sq_plain(queries, points, k, q_chunk, p_tile)
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx


def _launcher():
    fn = build.load("knn").knn_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def knn_sq_cuda(qpk: torch.Tensor, ppk: torch.Tensor, cand: torch.Tensor,
                m_total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: qpk [n_q·256, 3], ppk [3, Mp], cand [n_q, max_c]
    int32 → (d² [n_q·256, 8] f32, Morton-order idx [·, 8] int32).
    Counts the launch in `knn_sq_cuda.launches`."""
    dev = qpk.device
    if dev.type != "cuda":
        raise ValueError(f"knn_sq_cuda: tensors must be on CUDA, got {dev}")
    n_q, max_c = cand.shape
    Mp = ppk.shape[1]
    for name, t, dt, shape in (
        ("qpk", qpk, torch.float32, (n_q * KERNEL_TQ, 3)),
        ("ppk", ppk, torch.float32, (3, Mp)),
        ("cand", cand, torch.int32, (n_q, max_c)),
    ):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(
                f"knn_sq_cuda: {name} must be contiguous {dt} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if Mp % KERNEL_TP or not 0 < m_total <= Mp:
        raise ValueError(f"knn_sq_cuda: bad point padding Mp={Mp}, "
                         f"M={m_total} (tile {KERNEL_TP})")
    out_d = torch.empty(n_q * KERNEL_TQ, 8, dtype=torch.float32, device=dev)
    out_i = torch.empty(n_q * KERNEL_TQ, 8, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _launcher()(
            qpk.data_ptr(), ppk.data_ptr(), cand.data_ptr(), n_q, max_c, Mp,
            m_total, out_d.data_ptr(), out_i.data_ptr(), stream,
        )
    build.check(status, "knn_launch")
    knn_sq_cuda.launches += 1
    return out_d, out_i


knn_sq_cuda.launches = 0


def knn(
    queries=None,                      # [Q, 3]
    points=None,                       # [M, 3]
    k: Optional[int] = None,
    tq: int = KERNEL_TQ,
    tp: int = KERNEL_TP,
    prune: bool = True,
    prep: Optional[KnnPrep] = None,
    plan: Optional[KnnQueryPlan] = None,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of each query in the point set: (dist [Q, k] f32
    ascending, global idx [Q, k] int32), on the prep's device.

    Give `queries` with `points` or a reusable `prep`, or a prebuilt
    `plan` alone: a plan already fixes the queries, the point set and k,
    so combining it with any of them raises."""
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
    qpk = torch.from_numpy(plan.qpk).to(dev)
    if dev.type == "cuda":
        if k != 8 or plan.tq != KERNEL_TQ or prep.tp != KERNEL_TP:
            raise ValueError(
                f"the CUDA kernel is built for k=8, tq={KERNEL_TQ}, "
                f"tp={KERNEL_TP}; got k={k}, tq={plan.tq}, tp={prep.tp}"
            )
        d2, idx = knn_sq_cuda(qpk, prep.ppk,
                              torch.from_numpy(plan.cand).to(dev), M)
    else:
        d2, idx = knn_sq_plain(qpk, prep.ppk[:, :M].T, k)
    d = torch.sqrt(torch.clamp(d2[:plan.Q], min=0.0))
    # undo both permutations
    gidx = prep.pperm_t[torch.clamp(idx[:plan.Q].long(), max=M - 1)]
    qperm = torch.from_numpy(plan.qperm).to(dev)
    out_d = torch.empty_like(d)
    out_i = torch.empty(gidx.shape, dtype=torch.int32, device=dev)
    out_d[qperm] = d
    out_i[qperm] = gidx.to(torch.int32)
    return out_d, out_i
