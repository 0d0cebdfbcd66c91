"""Multi-host utilities: process-local data on a process mesh.

Ports nerfail_tpu/parallel/multihost.py. The JAX package assembles one
global `jax.Array` from every host's shard; under torch's one process per
card, a rank simply keeps its own shard on its device, and these helpers
check that the ranks agree on what they hold.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from nerfail_tpu_torch.parallel.mesh import Mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group at `tcp://<coordinator_address>` as rank
    `process_id` of `num_processes`; a no-op in single-process runs.
    `backend` defaults to NCCL when a card is visible, else gloo. A failed
    initialisation raises; nothing falls back to another backend."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("--num_processes needs --coordinator_address "
                         "host:port and --process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def _process_count_index():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_view_slice(n_views: int) -> slice:
    """Which views this process should load (contiguous split)."""
    pc, pi = _process_count_index()
    return view_slice_for(n_views, pc, pi)


def view_slice_for(n_views: int, process_count: int, process_index: int
                   ) -> slice:
    """Pure slicing math behind `process_view_slice` (unit-testable without
    a real multi-process runtime)."""
    per = (n_views + process_count - 1) // process_count
    return slice(
        process_index * per, min((process_index + 1) * per, n_views)
    )


def host_local_to_global(mesh: Mesh, local_batch, axis: str = "data"
                         ) -> torch.Tensor:
    """This rank's shard of a batch sharded over `axis`, on its device.

    Each rank passes its slice of the leading dim (`view_slice_for` order,
    so the last one may be shorter). The ranks' shapes are all-gathered
    over `axis` and must agree on every trailing dim; the global batch is
    their concatenation in axis order and is never assembled."""
    x = torch.as_tensor(np.asarray(local_batch) if not isinstance(
        local_batch, torch.Tensor) else local_batch)
    if x.ndim > 7:
        raise ValueError("host_local_to_global takes at most 7 dims")
    dims = torch.tensor([x.ndim] + list(x.shape) + [0] * (7 - x.ndim),
                        dtype=torch.int64, device=mesh.comm_device)
    every = mesh.all_gather(dims[None], axis=axis).cpu()
    if not bool((every[:, 0] == x.ndim).all()) or not bool(
            (every[:, 2:] == dims[2:].cpu()).all()):
        raise ValueError(
            f"shards along '{axis}' disagree on their trailing dims: "
            f"{[tuple(r[1:1 + int(r[0])].tolist()) for r in every]}")
    return x.to(mesh.device)


def replicate_global(mesh: Mesh, tree: Any):
    """Rank 0's copy of every array of `tree` (a tensor, an array, or a
    tuple / list / dict of them) on every rank's device.

    Each rank passes its own copy (every process loads the full feed, as
    in the JAX package); shapes and dtypes are checked on every rank
    against rank 0's, then the values are broadcast from rank 0."""

    def put(x):
        t = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(mesh.device).contiguous()
        meta = mesh.broadcast_object((tuple(t.shape), str(t.dtype)))
        if meta != (tuple(t.shape), str(t.dtype)):
            raise ValueError(f"rank {mesh.rank} holds {tuple(t.shape)} "
                             f"{t.dtype}, rank 0 {meta[0]} {meta[1]}")
        return mesh.broadcast(t.clone(), src=0)

    if isinstance(tree, dict):
        return {k: replicate_global(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_global(mesh, v) for v in tree)
    return put(tree)
