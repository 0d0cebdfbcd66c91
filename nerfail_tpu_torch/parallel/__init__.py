from nerfail_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for
from nerfail_tpu_torch.parallel.shard import (
    gather_nerf_params,
    local_rows,
    nerf_param_pspec,
    replicate,
    shard_batch,
    shard_nerf_params,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape_for",
    "nerf_param_pspec",
    "shard_nerf_params",
    "gather_nerf_params",
    "shard_batch",
    "replicate",
    "local_rows",
]
