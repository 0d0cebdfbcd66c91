"""Rank programs that run the port's sharded paths at small sizes.

Each function takes the rank's `Mesh` first and is run in every rank by
`parallel.launch.spawn` (tests/test_torch_parallel.py and
tests/test_torch_attack_mesh.py hold what they return against the
single-process port and the JAX package). They live in the package, which
imports no JAX, because spawned ranks import them by name. Inputs are
numpy arrays, so a rank builds its own tensors on `mesh.device`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def linear_logits_fn(Wc: np.ndarray, device) -> callable:
    """x [B, ...] → x.reshape(B, -1) @ Wc: the toy classifier of
    tests/test_attack_mesh_e2e.py."""
    W = torch.tensor(np.asarray(Wc), device=device)
    return lambda x: x.reshape(x.shape[0], -1) @ W


def _result(res) -> Dict:
    return {"delta": np.asarray(res.delta), "history": res.history,
            "best_attack_acc": res.best_attack_acc}


def layouts(mesh, params: Dict[str, np.ndarray], x: np.ndarray,
            local_views: np.ndarray) -> Dict:
    """The rank's parameter shards and their gathered round trip, its
    shard_batch rows, and host_local_to_global / replicate_global of its
    inputs."""
    from nerfail_tpu_torch.parallel.multihost import (
        host_local_to_global, replicate_global, view_slice_for,
    )
    from nerfail_tpu_torch.parallel.shard import (
        gather_nerf_params, shard_batch, shard_nerf_params,
    )

    p = {k: torch.as_tensor(v) for k, v in params.items()}
    shards = shard_nerf_params(mesh, p)
    back = gather_nerf_params(mesh, shards,
                              {k: tuple(v.shape) for k, v in p.items()})
    mine = local_views[view_slice_for(len(local_views), mesh.size,
                                      mesh.rank)]
    rep = replicate_global(mesh, {"x": x + mesh.rank})
    return {"shards": {k: v.detach().numpy() for k, v in shards.items()},
            "gathered": {k: v.detach().numpy() for k, v in back.items()},
            "batch": shard_batch(mesh, {"o": torch.as_tensor(x),
                                        "s": torch.tensor(3.0)}),
            "local": host_local_to_global(mesh, mine).numpy(),
            "replicated": rep["x"].numpy(), "rank": mesh.rank,
            "coords": (mesh.data_index, mesh.model_index)}


def host_local_mismatch(mesh) -> None:
    """host_local_to_global with shards whose trailing dims differ."""
    from nerfail_tpu_torch.parallel.multihost import host_local_to_global

    host_local_to_global(mesh, np.zeros((2, 3 + mesh.rank), np.float32))


def segment_sum_sharded_run(mesh, g: np.ndarray, idx: np.ndarray,
                            w: np.ndarray, M: int) -> Dict[bool, np.ndarray]:
    """g [V, HW, C], idx / w [V, HW, k]: segment_sum_sharded over the
    rank's views, {True: the shared-point sum all-reduced over "data",
    False: the per-view sums of its views (build_batched_csr_plan)}."""
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        build_batched_csr_plan, build_csr_plan, segment_sum_sharded,
    )
    from nerfail_tpu_torch.parallel.shard import local_rows

    dev = mesh.device
    g_l = local_rows(torch.as_tensor(g, device=dev), mesh)
    i_l = local_rows(torch.as_tensor(idx, device=dev), mesh)
    w_l = local_rows(torch.as_tensor(w, device=dev), mesh)
    g_l = g_l.reshape(-1, g.shape[-1])
    return {reduce: segment_sum_sharded(g_l, build(i_l, w_l, M), mesh,
                                        reduce=reduce).cpu().numpy()
            for reduce, build in ((True, build_csr_plan),
                                  (False, build_batched_csr_plan))}


def nerfail_s_run(mesh, delta0, weights, idx, ori, labels, Wc,
                  cfg_kwargs: Dict, epochs: Optional[int] = None) -> Dict:
    """nerfail_s_attack on the mesh with the linear toy classifier, and the
    number of the rank's classifier calls."""
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig

    linear, calls = linear_logits_fn(Wc, mesh.device), []

    def logits_fn(x):
        calls.append(x.shape[0])
        return linear(x)

    res = nerfail_s_attack(
        delta0, weights, idx, ori, labels, logits_fn,
        AttackConfig(**cfg_kwargs), resize_to=None, epochs=epochs, mesh=mesh)
    return {**_result(res), "classify_calls": len(calls)}


def nerfail_s_step_run(mesh, delta0, weights, idx, ori, labels, Wc,
                       cfg_kwargs: Dict) -> Dict:
    """One make_nerfail_s_step on the rank's "data" share of the views as
    one batch: the stepped δ, which must be the same on every rank."""
    from nerfail_tpu_torch.attacks.nerfail_s import make_nerfail_s_step
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import build_csr_plan
    from nerfail_tpu_torch.parallel.shard import local_rows

    dev = mesh.device
    cfg = AttackConfig(**cfg_kwargs)
    step = make_nerfail_s_step(linear_logits_fn(Wc, dev), cfg, None,
                               mesh=mesh)

    def rows(a, dtype=None):
        return local_rows(torch.as_tensor(a, device=dev, dtype=dtype), mesh)

    w, i, o = rows(weights), rows(idx), rows(ori, torch.float32)
    plan = build_csr_plan(i, w, delta0.reshape(-1, 4).shape[0],
                          pair_mask=o[..., 3:] > 0)
    d0 = torch.as_tensor(delta0, device=dev)
    new, m = step(d0, d0, w, i, o, rows(labels),
                  rows(np.ones(len(labels), np.float32)), plan)
    return {"delta": new.cpu().numpy(), "loss": float(m["loss"])}


def nerfail_run(mesh, delta0, weights, idx, ori, Wc, cfg_kwargs: Dict,
                epochs: Optional[int] = None) -> Dict:
    """nerfail_attack on the mesh with the linear toy classifier."""
    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.config import AttackConfig

    res = nerfail_attack(
        delta0, weights, idx, ori, linear_logits_fn(Wc, mesh.device),
        AttackConfig(**cfg_kwargs), resize_to=None, epochs=epochs,
        mesh=mesh)
    return _result(res)


def train_step_run(mesh, cfg_kwargs: Dict, params0: Dict, batch: Dict,
                   hw, steps: int = 1) -> Dict:
    """`steps` sharded make_train_step updates from the whole parameters
    `params0` ({"coarse": {name: array}, "fine": ...}) and a fresh Adam, on
    the given whole batch (rays, targets, uniforms); returns the whole
    parameters after them (gathered), the rank's shards and the losses."""
    from nerfail_tpu_torch.config import (
        NeRFModelConfig, RenderConfig, TrainConfig,
    )
    from nerfail_tpu_torch.models.nerf import nerf_params_from_jax
    from nerfail_tpu_torch.train.nerf_trainer import (
        NeRFTrainState, gather_train_state, make_optimizer, make_train_step,
        shard_train_state,
    )

    mcfg = NeRFModelConfig(**cfg_kwargs["model"])
    rcfg = RenderConfig(**cfg_kwargs["render"])
    tcfg = TrainConfig(**cfg_kwargs["train"])
    dev = mesh.device
    params = {k: nerf_params_from_jax(v, device=dev)
              for k, v in params0.items()}
    state = shard_train_state(mesh, NeRFTrainState(
        params, make_optimizer(tcfg, params), 0))
    step = make_train_step(mcfg, rcfg, tcfg, mesh=mesh)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    losses = [float(step(state, b, None, hw, 0.0)["loss"])
              for _ in range(steps)]
    whole = gather_train_state(mesh, state)
    return {"losses": losses,
            "params": {net: {k: v.detach().cpu().numpy()
                             for k, v in whole.params[net].items()}
                       for net in ("coarse", "fine")},
            "shards": {k: v.detach().cpu().numpy()
                       for k, v in state.params["coarse"].items()}}


def multi_step_run(mesh, cfg_kwargs: Dict, seed: int, images, poses, K,
                   k: int) -> Dict:
    """One make_multi_train_step window of k steps on the mesh against k
    eager sharded steps on the same (seed, i) draws (on the card, of the
    capturable Adam the window steps): the whole parameters of both."""
    from nerfail_tpu_torch.config import (
        NeRFModelConfig, RenderConfig, TrainConfig,
    )
    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, gather_train_state, make_capturable,
        make_multi_train_step, make_train_step, sample_rays,
        shard_train_state, step_seed,
    )

    mcfg = NeRFModelConfig(**cfg_kwargs["model"])
    rcfg = RenderConfig(**cfg_kwargs["render"])
    tcfg = TrainConfig(**cfg_kwargs["train"])
    dev = mesh.device
    imgs, pos, Kt = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (images, poses, K))
    out = {}
    a = shard_train_state(mesh, create_train_state(seed, mcfg, rcfg, tcfg,
                                                   dev))
    make_multi_train_step(mcfg, rcfg, tcfg, False, k, mesh=mesh)(
        a, imgs, pos, Kt, seed)
    b = shard_train_state(mesh, create_train_state(seed, mcfg, rcfg, tcfg,
                                                   dev))
    if dev.type == "cuda":         # the window's Adam (make_capturable)
        make_capturable(b.opt_state)
    step = make_train_step(mcfg, rcfg, tcfg, mesh=mesh)
    gen = torch.Generator(device=dev)
    for i in range(k):
        gen.manual_seed(step_seed(seed, i))
        batch = sample_rays(gen, imgs, pos, Kt, tcfg.N_rand, False,
                            tcfg.precrop_frac, tcfg.no_batching)
        step(b, batch, gen, tuple(imgs.shape[1:3]), 0.0)
    for name, st in (("window", a), ("eager", b)):
        whole = gather_train_state(mesh, st)
        out[name] = {k2: v.detach().cpu().numpy()
                     for k2, v in whole.params["coarse"].items()}
    return out


def train_nerf_run(mesh, cfg_kwargs: Dict, images, poses, K, i_train,
                   logdir: str, n_iters=(4,), seed: int = 0) -> List[Dict]:
    """train_nerf on the mesh with a log directory, once to each step count
    of `n_iters` in turn (each run resumes the last one's checkpoint);
    for each, the whole parameters, the step and the logged losses."""
    from nerfail_tpu_torch.config import (
        ExperimentConfig, NeRFModelConfig, RenderConfig, TrainConfig,
    )
    from nerfail_tpu_torch.train.nerf_trainer import train_nerf

    cfg = ExperimentConfig(model=NeRFModelConfig(**cfg_kwargs["model"]),
                           render=RenderConfig(**cfg_kwargs["render"]),
                           train=TrainConfig(**cfg_kwargs["train"]))
    out = []
    for n in n_iters:
        logs = []
        state = train_nerf(cfg, images, poses, K, i_train, seed=seed,
                           logdir=logdir, n_iters=n, mesh=mesh,
                           log_fn=lambda i, m: logs.append((i, m["loss"])))
        out.append({"step": state.step, "logs": logs,
                    "params": {k: v.detach().cpu().numpy()
                               for k, v in state.params["coarse"].items()}})
    return out


def fail_on_rank_1(mesh) -> None:
    """Rank 1 raises; rank 0 waits at a barrier that rank 1 never
    reaches."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()


def attack_mesh_runs(mesh, toy, cfg_s: Dict, cfg_n: Dict, root: str,
                     nerfail_epochs: int = 2) -> Dict:
    """Both 3D engines on the mesh, one NeRFail-S step, and
    Pipeline.stage_attack (NeRFail-S sharded, IGSM-2D on rank 0) writing
    its artifacts under `root`, on the toy inputs (delta0, weights, idx,
    ori, labels, Wc)."""
    from nerfail_tpu_torch.config import AttackConfig, ExperimentConfig
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline

    delta0, weights, idx, ori, labels, Wc = toy
    out = {
        "nerfail_s": nerfail_s_run(mesh, delta0, weights, idx, ori, labels,
                                   Wc, cfg_s),
        "step": nerfail_s_step_run(mesh, delta0, weights, idx, ori, labels,
                                   Wc, cfg_s),
        "nerfail": nerfail_run(mesh, delta0, weights, idx, ori, Wc, cfg_n,
                               nerfail_epochs),
    }
    pipe = Pipeline(ArtifactLayout(root), ExperimentConfig(), mesh=mesh)
    logits_fn = linear_logits_fn(Wc, mesh.device)
    for method in ("NeRFail_S", "IGSM_2D"):
        acfg = AttackConfig(method=method, **cfg_s)
        res = pipe.stage_attack(method, acfg, "chair", "toy", logits_fn,
                                None, ori, tables=(weights, idx),
                                mask_images=delta0, epochs=1)
        out[method] = _result(res)
    return out
