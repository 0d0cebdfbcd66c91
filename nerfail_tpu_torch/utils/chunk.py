"""Memory tiling over rays.

The reference trades memory for time with Python chunk loops
(`batchify_rays` run_nerf.py:54-66); the JAX package runs them as one
`lax.map` over a padded [tiles, chunk, ...] reshape. PyTorch runs eagerly,
so the port loops over chunks and leaves the last one short. Per-ray
functions give the same per-ray outputs either way.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def pad_to_multiple(x: torch.Tensor, multiple: int, dim: int = 0):
    """Pad `dim` up to a multiple with edge values; (padded, original size)."""
    n = x.shape[dim]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    edge = x.narrow(dim, n - 1, 1)
    reps = [1] * x.ndim
    reps[dim] = rem
    return torch.cat([x, edge.repeat(*reps)], dim=dim), n


def chunked_map(fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                xs: Dict[str, torch.Tensor], chunk: int) -> Dict[str, torch.Tensor]:
    """Apply `fn` (dict of [N, ...] tensors → dict of [N, ...] tensors) to
    chunks of `chunk` rows along dim 0 and concatenate the results."""
    n = next(iter(xs.values())).shape[0]
    if n <= chunk:
        return fn(xs)
    outs = [fn({k: v[s:s + chunk] for k, v in xs.items()})
            for s in range(0, n, chunk)]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


