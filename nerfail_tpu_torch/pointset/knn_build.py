"""Per-view neighbour tables: pixel surface coords → point-set top-8.

Re-designs `create_index_and_dist` (create_index_and_dist.py:22-171),
which chunks the point set, calls `torch.cdist`, sorts each chunk and
merges a running top-8. Three methods:

  * "device": on CUDA the K3 kernel over Morton-sorted, bbox-pruned
    candidate tiles (ops/cuda/knn_kernel); on the CPU its plain version,
    a streaming brute-force top-k;
  * "host": a scipy KD-tree;
  * "auto": "device" on CUDA; on the CPU the KD-tree above 10⁹
    query·point pairs (where the brute-force sweep loses to Q·log M) and
    "device" below.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep, knn, knn_plain
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device


def knn_host_tree(
    queries: np.ndarray,       # [Q, 3]
    points: np.ndarray,        # [M, 3]
    k: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN on the host via a KD-tree (scipy cKDTree)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(points, np.float32))
    dist, idx = tree.query(np.asarray(queries, np.float32), k=k, workers=-1)
    return dist.astype(np.float32), idx.astype(np.int32)


def build_index_and_dist(
    coord_map,                 # [H, W, 3] per-pixel world coords of one image
    point_set,                 # [M, 3] point set S
    k: int = 8,
    method: str = "auto",
    device: DeviceLike = "cuda",
    prep: Optional[KnnPrep] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image neighbor table: (dist [H,W,k] f32, idx [H,W,k] int32) as
    tensors on `device` — the artifact the reference saves as
    index_and_dist/{split}/{i}.pth (create_index_and_dist.py:148-163).

    `prep` is a KnnPrep of `point_set` on `device`, built once and reused
    across views by the "device" method on CUDA."""
    dev = resolve_device(device)
    coord_map = np.asarray(coord_map, np.float32)
    H, W = coord_map.shape[:2]
    queries = coord_map.reshape(-1, 3)
    M = point_set.shape[0]
    if method == "auto":
        if dev.type == "cuda":
            method = "device"
        else:
            method = "host" if H * W * M > 1_000_000_000 else "device"
    if method == "host":
        dist, idx = knn_host_tree(queries, np.asarray(point_set), k=k)
        dist, idx = torch.from_numpy(dist).to(dev), torch.from_numpy(idx).to(dev)
    elif method != "device":
        raise ValueError(f"unknown method {method!r}")
    elif dev.type == "cuda":
        if prep is None:
            prep = KnnPrep(np.asarray(point_set), device=dev)
        elif prep.device != dev or prep.M != M:
            raise ValueError("prep was built for another point set or device")
        dist, idx = knn(queries, prep=prep, k=k)
    else:
        dist, idx = knn_plain(
            torch.from_numpy(queries),
            torch.as_tensor(np.asarray(point_set, np.float32)), k=k,
        )
        idx = idx.to(torch.int32)
    return dist.reshape(H, W, k), idx.reshape(H, W, k)
