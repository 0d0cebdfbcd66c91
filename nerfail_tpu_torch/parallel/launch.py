"""Run a function in n ranks on one host, one process each.

The JAX package needs no launcher: one process drives every chip. Torch
runs one process per rank, so `spawn` starts them (torch.multiprocessing,
spawn start method), joins them into one process group that meets on a
`FileStore` in `store_dir` (no TCP port, so concurrent runs cannot
collide), gives each its device and its `Mesh`, and returns what each
rank's function returned. This is how `cli --num_devices N` runs on one
host, and how the tests run ranks.

A rank's exception re-raises in the parent as a RuntimeError naming the
rank; the other ranks are then terminated. When several ranks fail (a
rank's peers see its connection close), the first failure is reported.
The function must be importable by name from a module that imports no JAX
(it is pickled by reference).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
import uuid
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600.0      # a rank stuck this long in a collective raises


def _rank_main(rank: int, fn: Callable, n_ranks: int, backend: str,
               store_path: str, device_type: str,
               model_parallel: Optional[int], args: Sequence,
               result_dir: str, num_threads: Optional[int]) -> None:
    from nerfail_tpu_torch.parallel.mesh import make_mesh

    if num_threads:
        torch.set_num_threads(num_threads)
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    store = dist.FileStore(store_path, n_ranks)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=n_ranks,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh(n_ranks, model_parallel, device=dev)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(result_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(result_dir, f"error{rank}.txt"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(result_dir: str, n_ranks: int) -> str:
    """'rank r of n failed:' and the traceback of the rank that failed
    first, by the time each failed rank wrote down."""
    found = []
    for r in range(n_ranks):
        path = os.path.join(result_dir, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                when, _, tb = f.read().partition("\n")
            found.append((float(when), r, tb))
    if not found:
        return ""
    _, r, tb = min(found)
    others = sorted(x[1] for x in found if x[1] != r)
    also = f" (then ranks {others})" if others else ""
    return f"rank {r} of {n_ranks} failed{also}:\n{tb}"


def spawn(fn: Callable, n_ranks: int, backend: Optional[str] = None,
          store_dir: Optional[str] = None, device_type: str = "cpu",
          model_parallel: Optional[int] = None, args: Sequence = (),
          num_threads: Optional[int] = None) -> List[Any]:
    """fn(mesh, *args) in `n_ranks` processes; returns each rank's result
    in rank order (saved with torch.save, so tensors come back on the
    devices they were on).

    `backend` defaults to NCCL for `device_type` "cuda" and gloo for
    "cpu"; rank r takes `cuda:<r mod device_count>`, so gloo may put
    several ranks on one card, NCCL may not. The mesh is
    make_mesh(n_ranks, model_parallel). `store_dir` (default: a temporary
    directory) holds the rendezvous file and the results. A collective
    that waits longer than TIMEOUT_S raises."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"NCCL needs a card per rank: {n_ranks} ranks, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store_path = os.path.join(tmp, f"store-{uuid.uuid4().hex}")
        try:
            mp.start_processes(
                _rank_main, nprocs=n_ranks, join=True, start_method="spawn",
                args=(fn, n_ranks, backend, store_path, device_type,
                      model_parallel, tuple(args), tmp, num_threads))
        except mp.ProcessRaisedException as e:
            raise RuntimeError(_first_failure(tmp, n_ranks) or (
                f"rank {e.error_index} of {n_ranks} failed:\n{e}")
            ) from None
        except mp.ProcessExitedException as e:
            raise RuntimeError(_first_failure(tmp, n_ranks) or (
                f"rank {e.error_index} of {n_ranks} exited with code "
                f"{e.exit_code}")) from None
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
