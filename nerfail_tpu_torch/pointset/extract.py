"""Spatial-point-set extraction: render → per-pixel 3D coords → point set.

Ports nerfail_tpu/pointset/extract.py (the reference's nerf_to_coord.py /
create_index_and_dist.py stages):
  * `extract_coord_maps` renders each pose and keeps `pts_max` (the
    dominant 3D sample per ray) and `rgb_map`;
  * `build_point_set` stacks the mask views' maps into S [p·H·W, 3]
    (create_index_and_dist.py:57-61, view-major);
  * `build_neighbor_tables` gives each pixel its k nearest points of S and
    their Gaussian weights (K3 on the card).
Artifacts are .npz arrays under an artifact directory.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from nerfail_tpu_torch.config import ExperimentConfig, PointSetConfig
from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep
from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
from nerfail_tpu_torch.pointset.weights import gauss_weights
from nerfail_tpu_torch.render import render_full_image
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device
from nerfail_tpu_torch.utils.profiling import span


def extract_coord_maps(
    params: Dict,
    cfg: ExperimentConfig,
    poses: np.ndarray,      # [N, 4, 4]
    H: int,
    W: int,
    K: np.ndarray,
    save_dir: Optional[str] = None,
    save_rgb: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render every pose on the parameters' device; (coords [N,H,W,3],
    rgbs [N,H,W,3]) as numpy."""
    coords, rgbs = [], []
    for i in range(poses.shape[0]):
        with span("render.view"):
            out = render_full_image(params["coarse"], params["fine"],
                                    cfg.model, cfg.render, H, W, K, poses[i])
            with span("render.to_host"):
                coords.append(out["pts_max"].cpu().numpy())
                rgbs.append(out["rgb_map"].cpu().numpy())
    coords, rgbs = np.stack(coords), np.stack(rgbs)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.savez_compressed(os.path.join(save_dir, "coords.npz"), coords=coords)
        if save_rgb:
            np.savez_compressed(os.path.join(save_dir, "rgbs.npz"), rgbs=rgbs)
    return coords, rgbs


def build_point_set(mask_coord_maps: np.ndarray) -> np.ndarray:
    """S = the p mask views' pixel coords, [p·H·W, 3], view-major."""
    p, H, W, _ = mask_coord_maps.shape
    return mask_coord_maps.reshape(p * H * W, 3)


def build_neighbor_tables(
    coord_maps: np.ndarray,        # [N, H, W, 3] coords of the views
    point_set: np.ndarray,         # [M, 3]
    pcfg: PointSetConfig = PointSetConfig(),
    save_path: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """(weights [N,H,W,k], idx [N,H,W,k]): the index_and_weight artifact
    (GaussNet.py:161-186). On CUDA every view runs K3 against one KnnPrep
    of the point set."""
    dev = resolve_device(device)
    S = np.asarray(point_set, np.float32)
    prep = KnnPrep(S, device=dev) if dev.type == "cuda" else None
    all_w, all_i = [], []
    for n in range(coord_maps.shape[0]):
        dist, idx = build_index_and_dist(coord_maps[n], S, k=pcfg.k,
                                         device=dev, prep=prep)
        all_w.append(gauss_weights(dist, pcfg.gauss_c, pcfg.gauss_eps)
                     .cpu().numpy())
        all_i.append(idx.cpu().numpy())
    weights, idxs = np.stack(all_w), np.stack(all_i)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        np.savez_compressed(save_path, weights=weights, idx=idxs)
    return weights, idxs
