"""Device-mesh construction over torch.distributed.

Ports nerfail_tpu/parallel/mesh.py. The JAX package is single-controller:
one process drives every chip and XLA inserts the collectives. Here every
card has a process of its own (SPMD) and the program calls the collectives
itself, on the two axes the JAX mesh names:

  axis "data"  — rays / pixels / views: each rank takes its slice, and the
                 gradients (the attack's perturbation gradient, the NeRF's
                 parameter gradients) are all-reduced over the axis
  axis "model" — the MLP hidden width: parameters and Adam moments are
                 stored as shards along it and gathered whole before the
                 fused MLP kernels, which need whole weights

Ranks are laid out row-major, rank = data_index · model + model_index, so a
model group holds consecutive ranks (one host's cards) and the data axis
spans hosts, as the JAX mesh puts the model axis inside a host.

`Mesh` holds the torch DeviceMesh, its two process groups, this rank's
coordinates and its device. The collectives here are on plain tensors; the
port has no DTensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from nerfail_tpu_torch.utils.devices import DeviceLike

AXES = ("data", "model")


def mesh_shape_for(n_devices: int, model_parallel: Optional[int] = None
                   ) -> Tuple[int, int]:
    """(data, model) factors for n devices. Model axis defaults to the
    largest power of two ≤ min(n, 4) that divides n — 256-wide layers tile
    onto ≤4 chips at 128-lane granularity without padding waste."""
    if model_parallel is None:
        model_parallel = 1
        for cand in (2, 4):
            if n_devices % cand == 0 and cand <= n_devices:
                model_parallel = cand
    assert n_devices % model_parallel == 0
    return n_devices // model_parallel, model_parallel


@dataclass(frozen=True)
class Mesh:
    """A (data, model) process mesh seen from one rank.

    `shape` is a dict as `jax.sharding.Mesh.shape` is, so that
    `mesh.shape.get("data", 1)` reads the same in both packages. `device`
    is this rank's device: `cuda:<i>` (set current before the mesh was
    made) or `cpu`."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.device_mesh.mesh.shape))

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.device_mesh.get_group(axis)

    @property
    def data_group(self) -> dist.ProcessGroup:
        return self.group("data")

    @property
    def model_group(self) -> dist.ProcessGroup:
        return self.group("model")

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    @property
    def data_index(self) -> int:
        return self.index("data")

    @property
    def model_index(self) -> int:
        return self.index("model")

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def size(self) -> int:
        return dist.get_world_size()

    @property
    def backend(self) -> str:
        return str(dist.get_backend()).lower()

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes every file of a sharded run."""
        return self.rank == 0

    @property
    def comm_device(self) -> torch.device:
        """Where the host control plane's small collective buffers live:
        the card under NCCL, the CPU under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    # ---- collectives on plain tensors ----

    def all_reduce(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """In-place sum of `t` over `axis`; returns `t`."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "data",
                   dim: int = 0) -> torch.Tensor:
        """The tensors of every rank along `axis`, concatenated along `dim`
        in axis order. Every rank passes the same shape. Gloo gathers CUDA
        tensors through the host."""
        group = self.group(axis)
        n = dist.get_world_size(group)
        src = t.contiguous()
        if self.backend == "gloo" and src.is_cuda:
            src = src.cpu()
        parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In-place broadcast of `t` from global rank `src`; returns `t`."""
        dist.broadcast(t, src=src)
        return t

    def broadcast_object(self, obj, src: int = 0):
        """A picklable host value of global rank `src`, on every rank."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=src,
                                   device=self.comm_device)
        return box[0]

    def barrier(self) -> None:
        """Every rank waits here until all have arrived (after rank 0's
        writes, before anything reads them back)."""
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: Optional[int] = None,
    axis_names=AXES,
    device: Optional[DeviceLike] = None,
) -> Mesh:
    """The (data, model) mesh of the initialised process group.

    `n_devices` must equal the world size (default: the world size);
    `model_parallel` as `mesh_shape_for`. `device` defaults to the current
    CUDA device under NCCL and to the CPU under gloo; a `cuda` device
    without an index means the current one."""
    if tuple(axis_names) != AXES:
        raise ValueError(f"axis names must be {AXES}, not {axis_names}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group (one process per "
            "rank: parallel.launch.spawn, or initialize_distributed)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks, the "
                         f"process group has {world}")
    dp, tp = mesh_shape_for(n, model_parallel)
    if device is None:
        device = ("cuda" if str(dist.get_backend()).lower() == "nccl"
                  else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh(dev.type, (dp, tp), mesh_dim_names=AXES)
    return Mesh(dm, dev)
