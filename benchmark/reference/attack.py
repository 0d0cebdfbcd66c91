"""Plain float32 NeRFail pieces (NeRFail, AAAI 2024; GaussNet.py and
attack_NeRFail_S.py): exact 8-nearest-neighbour tables with Gaussian
weights, the splat, the composite, the antialiased bilinear resize, and
one NeRFail-S sign step, in plain torch with autograd.

  splat    = sum_j w_j * s[idx_j]                 (s: [M, 4] RGBA, 0-255)
  r        = clip(splat_rgb * splat_a / 255, -eps, eps)
  attacked = clip(where(ori_a > 0, ori_rgb + r, 0), 0, 255)
  input    = resize(where(ori_a > 0, attacked, 255)) -> classifier
  step     : s_rgb += a * sign(d CE / d s_rgb), zero where s_a == 0,
             clipped into [s0 - eps, s0 + eps]

The resize is jax.image.resize(method="bilinear", antialias=True) as the
reference port runs it: per axis a triangle kernel widened by the scale
factor when shrinking, each output's weights normalised to sum 1.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of the antialiased bilinear resize."""
    if n_in == n_out:
        return torch.eye(n_in, device=device)
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    x_out = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    x_in = torch.arange(n_in, dtype=torch.float64)
    w = (1.0 - (x_out[:, None] - x_in[None, :]).abs() / kernel_scale).clamp(
        min=0.0)
    w = w / w.sum(1, keepdim=True)
    inside = (x_out >= -0.5) & (x_out <= n_in - 0.5)
    w = torch.where(inside[:, None], w, torch.zeros_like(w))
    return w.to(torch.float32).to(device)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C]: the W axis, then the H axis."""
    if x.shape[1] == size:
        return x
    A_w = resize_matrix(x.shape[2], size, x.device)
    A_h = resize_matrix(x.shape[1], size, x.device)
    y = torch.einsum("bhwc,vw->bhvc", x, A_w)
    return torch.einsum("bhvc,uh->buvc", y, A_h)


def gauss_weights(dist: torch.Tensor, c: float = 0.02,
                  eps: float = 0.001) -> torch.Tensor:
    """GaussNet.py create_gauss_w: exp(-(d/c)^2/2) / (sum + eps)."""
    w = torch.exp(-((dist / c) ** 2) / 2.0)
    total = w.sum(-1, keepdim=True)
    return torch.where(total > 0, w / (total + eps), torch.zeros_like(w))


@torch.no_grad()
def knn(queries: torch.Tensor, points: torch.Tensor, k: int = 8,
        block: int = 1 << 18) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest points of each query by Euclidean distance computed
    from coordinate differences (no |q|^2 + |p|^2 - 2 q.p), over blocks of
    the point set: (dist [Q, k] ascending, idx [Q, k] int64)."""
    best_d = torch.full((queries.shape[0], k), float("inf"),
                        device=queries.device)
    best_i = torch.zeros((queries.shape[0], k), dtype=torch.int64,
                         device=queries.device)
    for s in range(0, points.shape[0], block):
        p = points[s:s + block]
        d = torch.cdist(queries, p, compute_mode="donot_use_mm_for_euclid_dist")
        dd, ii = torch.topk(d, min(k, p.shape[0]), dim=1, largest=False)
        cat_d = torch.cat([best_d, dd], 1)
        cat_i = torch.cat([best_i, ii + s], 1)
        best_d, order = torch.topk(cat_d, k, dim=1, largest=False)
        best_i = cat_i.gather(1, order)
    return best_d, best_i


def exact_dist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[Q, P] Euclidean distances from coordinate differences."""
    return torch.cdist(q, p, compute_mode="donot_use_mm_for_euclid_dist")


def product_dist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[Q, P] distances from |q|^2 + |p|^2 - 2 q.p, the product in the
    matmul precision in force (the control runs it in TF32)."""
    d2 = ((q * q).sum(1, keepdim=True) + (p * p).sum(1)[None, :]
          - 2.0 * q @ p.T)
    return d2.clamp(min=0.0).sqrt()


# the grids' cell sizes, finest first: the last is the search's reach
CELLS = (0.04, 0.1, 0.3)
PAIRS = 1 << 27   # distances worked out at once, 512 MiB of float32


def _cells(x: torch.Tensor, origin: torch.Tensor, h: float,
           dims: torch.Tensor) -> torch.Tensor:
    """Linear cell keys, worked out in float64 so that a point and a query
    two cells apart lie at least h apart."""
    c = torch.floor((x.double() - origin) / h).long()
    return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]


@torch.no_grad()
def grid_knn(queries: torch.Tensor, points: torch.Tensor, k: int = 8,
             dist_fn: Callable = exact_dist
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of each query, exact for every neighbour nearer
    than CELLS[-1]: (dist [Q, k] ascending, idx [Q, k] int64), with dist
    inf and idx 0 where no point lies that near.

    On a grid of cell size h, every point outside the 27 cells around a
    query's own lies at least h away, so a query whose k-th nearest within
    those cells is nearer than h is answered exactly; the others go on to
    the next, coarser grid. The last grid answers the rest for the
    neighbours nearer than its cell size."""
    n, dev = queries.shape[0], queries.device
    best_d = torch.full((n, k), float("inf"), device=dev)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=dev)
    todo = torch.arange(n, device=dev)
    lo = torch.minimum(points.amin(0), queries.amin(0)).double()
    hi = torch.maximum(points.amax(0), queries.amax(0)).double()
    offsets = torch.stack(torch.meshgrid(
        *[torch.arange(-1, 2, device=dev)] * 3, indexing="ij"), -1).view(-1, 3)
    for level, h in enumerate(CELLS):
        last = level == len(CELLS) - 1
        origin = lo - h
        dims = torch.floor((hi - origin) / h).long() + 3
        pkey = _cells(points, origin, h, dims)
        pkey, porder = torch.sort(pkey)
        q = queries[todo]
        qkey = _cells(q, origin, h, dims)
        qkey, qorder = torch.sort(qkey)
        todo, q = todo[qorder], q[qorder]
        groups, sizes = torch.unique_consecutive(qkey, return_counts=True)
        # the 27 neighbour cells of each group: [G, 27] ranges of porder
        cz = groups % dims[2]
        cy = (groups // dims[2]) % dims[1]
        cx = groups // (dims[1] * dims[2])
        nb = torch.stack([cx, cy, cz], -1)[:, None, :] + offsets[None]
        nkey = (nb[..., 0] * dims[1] + nb[..., 1]) * dims[2] + nb[..., 2]
        start = torch.searchsorted(pkey, nkey)
        count = torch.searchsorted(pkey, nkey, right=True) - start
        totals = count.sum(1)
        s = 0
        for g, (size, total) in enumerate(zip(sizes.tolist(),
                                              totals.tolist())):
            rows = slice(s, s + size)
            s += size
            if total == 0:
                continue
            c = count[g]
            first = torch.cumsum(c, 0) - c
            j = torch.arange(total, device=dev)
            cand = porder[torch.repeat_interleave(start[g] - first, c,
                                                  output_size=total) + j]
            p = points[cand]
            kk, step = min(k, total), max(1, PAIRS // total)
            for a in range(rows.start, rows.stop, step):
                b = min(a + step, rows.stop)
                d, i = torch.topk(dist_fn(q[a:b], p), kk, dim=1,
                                  largest=False)
                if kk < k:
                    d = torch.cat([d, torch.full((b - a, k - kk), float(
                        "inf"), device=dev)], 1)
                    i = torch.cat([i, i.new_zeros((b - a, k - kk))], 1)
                best_d[todo[a:b]] = d
                best_i[todo[a:b]] = cand[i]
        # a query none of whose 27 cells holds a point keeps what a finer
        # grid found, all of it at least h away, so it is not answered
        near = best_d[todo, -1] < h * (1.0 - 1e-5)  # margin for rounding
        if last:
            far = best_d >= h * (1.0 - 1e-5)
            best_d[far] = float("inf")
            best_i[far] = 0
            break
        todo = todo[~near]
        if todo.numel() == 0:
            break
    return best_d, best_i


def splat(points: torch.Tensor, idx: torch.Tensor,
          w: torch.Tensor) -> torch.Tensor:
    """points [M, C], idx and w [..., k] -> [..., C]."""
    rows = points[idx.reshape(-1).long()].reshape(*idx.shape, -1)
    return (w[..., None] * rows).sum(-2)


def classifier_input(delta: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                     ori: torch.Tensor, eps: float, size: int) -> torch.Tensor:
    """The attacked views as the classifier sees them: [B, size, size, 3]."""
    s = splat(delta.reshape(-1, 4), idx, w)
    r = (s[..., :3] * (s[..., 3:4] / 255.0)).clamp(-eps, eps)
    ori_a = ori[..., 3:4]
    x = torch.where(ori_a > 0, ori[..., :3] + r, torch.zeros_like(r))
    x = x.clamp(0.0, 255.0)
    x = torch.where(ori_a > 0, x, torch.full_like(x, 255.0))
    return resize(x, size)


def nerfail_s_step(delta: torch.Tensor, delta0: torch.Tensor,
                   w: torch.Tensor, idx: torch.Tensor, ori: torch.Tensor,
                   labels: torch.Tensor, logits_fn: Callable, eps: float,
                   a: float, size: int) -> torch.Tensor:
    """One untargeted sign step (beta 0) from delta over one batch of
    views."""
    d = delta.detach().requires_grad_(True)
    logits = logits_fn(classifier_input(d, w, idx, ori.float(), eps, size))
    loss = F.cross_entropy(logits, labels.long())
    (g,) = torch.autograd.grad(loss, d)
    with torch.no_grad():
        rgb = delta[..., :3] + a * torch.sign(g[..., :3])
        alpha = delta[..., 3:4]
        rgb = torch.where(alpha > 0, rgb, torch.zeros_like(rgb))
        rgb = torch.maximum(torch.minimum(rgb, delta0[..., :3] + eps),
                            delta0[..., :3] - eps)
        return torch.cat([rgb, alpha], -1)
