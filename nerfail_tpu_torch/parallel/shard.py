"""Sharding specs for NeRF params and batches.

Ports nerfail_tpu/parallel/shard.py. Tensor-parallel layout of the MLP:
hidden width on the "model" axis.

  pts_i_w   [in, W]   → (None, "model")     (column parallel)
  pts_i_b   [W]       → ("model",)
  feature_w [W, W]    → (None, "model")
  alpha_w   [W, 1]    → ("model", None)     (row parallel)
  views_w   [W+v, W/2]→ (None, "model")
  rgb_w     [W/2, 3]  → ("model", None)

The JAX program lets XLA insert the collectives around its sharded
matmuls; its fused MLP kernel still needs whole weights. The port stores
parameters and Adam moments as these shards, all-gathers them over the
"model" group before the fused kernels (K4/K5) and slices the whole
gradient back to the shard (train/nerf_trainer). Ray and view batches
ride the "data" axis: each rank keeps its slice of the leading dim.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from nerfail_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]


def nerf_param_pspec(name: str) -> Spec:
    if name.endswith("_b"):
        # biases of width-sharded layers
        if name.startswith(("pts_", "feature", "views")):
            return ("model",)
        return (None,)
    if name.startswith("pts_") or name in ("feature_w", "views_w"):
        return (None, "model")
    if name in ("alpha_w", "rgb_w", "output_w"):
        return ("model", None)
    return (None,)


def _shard_dim(mesh: Mesh, name: str, shape) -> Optional[int]:
    """The dim of `name` split over "model", or None: a replicated spec,
    or a dim that does not divide (tiny test configs), stays whole."""
    tp = mesh.shape.get("model", 1)
    for d, ax in enumerate(nerf_param_pspec(name)):
        if ax is not None and d < len(shape) and shape[d] % tp == 0:
            return d
    return None


def shard_tensor(mesh: Mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's "model" shard of parameter-shaped `t` (a parameter or
    one of its Adam moments), as a tensor of its own."""
    d = _shard_dim(mesh, name, t.shape)
    if d is None:
        return t.detach().clone()
    n = t.shape[d] // mesh.shape["model"]
    return t.detach().narrow(d, mesh.model_index * n, n).clone()


def gather_tensors(mesh: Mesh, items) -> list:
    """The whole tensors of `items`, (name, this rank's shard, whole shape)
    triples, from every rank's "model" shards: one all-gather over the
    model group of all the split shards in one flat buffer (each rank's is
    the same size). A tensor that `shard_tensor` kept whole comes back as
    it is."""
    tp = mesh.shape["model"]
    dims = [_shard_dim(mesh, name, shape) for name, _, shape in items]
    split = [t.detach().reshape(-1) for (_, t, _), d in zip(items, dims)
             if d is not None]
    if not split:
        return [t for _, t, _ in items]
    flat = mesh.all_gather(torch.cat(split), axis="model")
    per_rank = flat.view(tp, -1)
    out, offset = [], 0
    for (_, t, _), d in zip(items, dims):
        if d is None:
            out.append(t)
            continue
        n = t.numel()
        parts = [per_rank[r, offset:offset + n].view(t.shape)
                 for r in range(tp)]
        out.append(torch.cat(parts, dim=d))
        offset += n
    return out


def shard_nerf_params(mesh: Mesh, params: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """This rank's slice of each parameter along the "model" axis, a leaf
    that requires grad as the parameter does."""
    return {k: shard_tensor(mesh, k, v).requires_grad_(v.requires_grad)
            for k, v in params.items()}


def gather_nerf_params(mesh: Mesh, local: Dict[str, torch.Tensor],
                       shapes: Dict[str, Tuple[int, ...]]
                       ) -> Dict[str, torch.Tensor]:
    """The whole parameters, of shapes `shapes`, from every rank's shards
    (all-gather over the "model" group)."""
    names = list(local)
    got = gather_tensors(mesh, [(k, local[k], shapes[k]) for k in names])
    return dict(zip(names, got))


def local_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data"
               ) -> torch.Tensor:
    """This rank's contiguous slice of the leading dim over `axis` (the
    JAX package's `constrain_data`, P("data") on the leading dim). The
    dim must divide."""
    n = mesh.shape.get(axis, 1)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} does not divide over "
                         f"the '{axis}' axis of {n}")
    per = x.shape[0] // n
    return x[mesh.index(axis) * per:(mesh.index(axis) + 1) * per]


def shard_batch(mesh: Mesh, batch: Any, axis: str = "data"):
    """This rank's slice of the leading dim of every tensor of `batch` (a
    tensor or a dict / list / tuple of them), on the rank's device; a
    scalar, or a leading dim that does not divide, stays whole."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, axis) for v in batch)
    x = torch.as_tensor(batch).to(mesh.device)
    if x.ndim == 0 or x.shape[0] % mesh.shape.get(axis, 1):
        return x
    return local_rows(x, mesh, axis)


def replicate(mesh: Mesh, tree: Any):
    """Every tensor of `tree` whole on the rank's device."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return torch.as_tensor(tree).to(mesh.device)
