"""NeRF training: sample rays, render coarse + fine, MSE, Adam.

Ports nerfail_tpu/train/nerf_trainer.py. Loss, schedule and
hyperparameters are the reference's:
  loss   = MSE(fine) + MSE(coarse)                 (run_nerf.py:781-789)
  lr     = lrate · 0.1^(step / (lrate_decay·1000)) (run_nerf.py:796-800),
           set before update `step`, counting from 0 as optax's
           exponential_decay counts
  Adam   betas (0.9, 0.999), ε 1e-8                (run_nerf.py:196)
  precrop: the first `precrop_iters` steps sample from the central
           `precrop_frac` window                   (run_nerf.py:744-773)

Images and poses live on the training device and rays are drawn there.
Step i draws from a generator seeded by (seed, i), as the JAX trainer folds
the step into its key, so a resumed run draws what an unbroken one does.
A `sampler` can replace the draws (tests feed both packages the same rays
and uniforms).

`make_multi_train_step` (the JAX trainer's k steps in one `lax.scan`)
captures k whole steps (draws, coarse + fine render through K4, backward
through K5, Adam) as one CUDA graph on the card and replays it for every
window of k steps. It turns the state's Adam into a capturable one whose
learning rate is a device tensor, computed in the graph from a device
step counter (`make_capturable`); the eager step keeps the plain Adam
with a float learning rate.

With a process `mesh` (parallel/mesh.py; every rank runs the same
program) the step is data- and tensor-parallel as the JAX trainer's:
  * draws: every rank draws the whole batch (rays, then the renderer's
    uniforms and noise, in the renderer's order) from the same (seed, i)
    generator and keeps its "data" rows, so the draws are one device's;
  * loss: each rank's MSE is scaled by its share of the rays, and the
    gradients (with the losses) are all-reduced over "data";
  * "model" axis: parameters and Adam moments are stored as shards
    (`shard_train_state`, parallel/shard.py's specs) and all-gathered
    whole before the fused kernels, which need whole weights; the whole
    gradient is sliced back to the shard, not summed over "model" (the
    model ranks computed the same rays).
Checkpoints keep the one-device format: the shards are gathered and rank
0 writes, so a sharded run resumes an unsharded checkpoint and the
reverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nerfail_tpu_torch.config import (
    ExperimentConfig,
    NeRFModelConfig,
    RenderConfig,
    TrainConfig,
)
from nerfail_tpu_torch.models.nerf import Params, init_nerf_params
from nerfail_tpu_torch.ops.rays import ndc_rays
from nerfail_tpu_torch.parallel.shard import (
    gather_tensors, local_rows, shard_tensor,
)
from nerfail_tpu_torch.render import render_full_image, render_rays
from nerfail_tpu_torch.train.checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device
from nerfail_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


@dataclass
class NeRFTrainState:
    params: Dict[str, Params]        # {"coarse": ..., "fine": ...}
    opt_state: torch.optim.Optimizer  # Adam over every distinct leaf
    step: int
    # whole shapes of a sharded state's parameters ({"coarse": {name:
    # shape}, ...}); None when the parameters are whole
    shapes: Optional[Dict[str, Dict[str, Tuple[int, ...]]]] = None


def lr_at(tcfg: TrainConfig, step: int) -> float:
    """The learning rate of update `step` (0-based)."""
    return tcfg.lrate * 0.1 ** (step / (tcfg.lrate_decay * 1000))


def lr_tensor(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """`lr_at` on the step's device: `step` a float64 0-dim tensor, the
    result float32, computed in float64 (no host value, so a CUDA graph
    can hold it)."""
    return (tcfg.lrate * torch.pow(0.1, step / (tcfg.lrate_decay * 1000))
            ).to(torch.float32)


def _set_lr(opt: torch.optim.Optimizer, tcfg: TrainConfig, step) -> None:
    """Set update `step`'s learning rate: into the lr tensor of a
    capturable Adam (from `step`, an int or a float64 device counter), or
    as a float into a plain one."""
    for group in opt.param_groups:
        lr = group["lr"]
        if torch.is_tensor(lr):
            if not torch.is_tensor(step):
                step = torch.full((), float(step), dtype=torch.float64,
                                  device=lr.device)
            lr.copy_(lr_tensor(tcfg, step))
        else:
            group["lr"] = lr_at(tcfg, int(step))


def _leaves(params: Dict[str, Params]):
    seen, out = set(), []
    for name in ("coarse", "fine"):
        for t in params[name].values():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _leaf_names(params: Dict[str, Params]) -> List[Tuple[str, str]]:
    """(net, name) of each leaf of `_leaves`, in its order."""
    seen, out = set(), []
    for net in ("coarse", "fine"):
        for k, t in params[net].items():
            if id(t) not in seen:
                seen.add(id(t))
                out.append((net, k))
    return out


def _map_params(params: Dict[str, Params], fn) -> Dict[str, Params]:
    """fn(name, tensor) over both nets; a fine net that is the coarse one
    stays the coarse one."""
    out = {"coarse": {k: fn(k, v) for k, v in params["coarse"].items()}}
    out["fine"] = (out["coarse"] if params["fine"] is params["coarse"]
                   else {k: fn(k, v) for k, v in params["fine"].items()})
    return out


def shard_train_state(mesh, state: NeRFTrainState) -> NeRFTrainState:
    """This rank's "model" shards of a whole train state: each parameter
    and its Adam moments sliced by parallel/shard.py's specs, in an Adam
    with the same settings and step counts."""
    params = _map_params(state.params, lambda k, v: shard_tensor(
        mesh, k, v).requires_grad_(True))
    shapes = {net: {k: tuple(v.shape) for k, v in state.params[net].items()}
              for net in ("coarse", "fine")}
    sd = state.opt_state.state_dict()
    names = _leaf_names(state.params)
    sd["state"] = {i: {n: shard_tensor(mesh, names[i][1], v)
                       if n.startswith("exp_avg") else v
                       for n, v in st.items()}
                   for i, st in sd["state"].items()}
    opt = torch.optim.Adam(_leaves(params))
    opt.load_state_dict(sd)
    return NeRFTrainState(params, opt, state.step, shapes)


def _whole_state_dict(mesh, state: NeRFTrainState) -> Dict[str, Any]:
    """`_state_dict` of a sharded state in the one-device format: every
    parameter and Adam moment all-gathered over "model" (a collective:
    every rank calls it)."""
    if state.shapes is None:
        return _state_dict(state)
    names = _leaf_names(state.params)
    shape = {name: state.shapes[name[0]][name[1]] for name in names}
    got = gather_tensors(mesh, [(k, state.params[net][k], shape[(net, k)])
                                for net, k in names])
    whole = dict(zip(names, got))
    params = {net: {k: whole[(net, k)] for k in state.params[net]}
              for net in ("coarse", "fine")
              if net == "coarse" or state.params["fine"] is not
              state.params["coarse"]}
    params.setdefault("fine", params["coarse"])
    sd = state.opt_state.state_dict()
    moments = [(i, n) for i, st in sorted(sd["state"].items())
               for n in st if n.startswith("exp_avg")]
    got = gather_tensors(mesh, [(names[i][1], sd["state"][i][n],
                                 shape[names[i]]) for i, n in moments])
    sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
    for (i, n), t in zip(moments, got):      # the copies, not the live state
        sd["state"][i][n] = t
    return {"params": params, "opt_state": sd, "step": state.step}


def gather_train_state(mesh, state: NeRFTrainState) -> NeRFTrainState:
    """The whole train state of a sharded one (a collective: every rank
    calls it), on the mesh's device: what one device would hold."""
    if state.shapes is None:
        return state
    sd = _whole_state_dict(mesh, state)
    whole = {net: {k: v.detach().clone().requires_grad_(True)
                   for k, v in sd["params"][net].items()}
             for net in ("coarse", "fine")}
    if state.params["fine"] is state.params["coarse"]:
        whole["fine"] = whole["coarse"]
    opt = torch.optim.Adam(_leaves(whole))
    opt.load_state_dict(sd["opt_state"])
    return NeRFTrainState(whole, opt, state.step)


def make_optimizer(tcfg: TrainConfig, params: Dict[str, Params]
                   ) -> torch.optim.Adam:
    return torch.optim.Adam(_leaves(params), lr=tcfg.lrate,
                            betas=(0.9, 0.999), eps=1e-8)


def make_capturable(opt: torch.optim.Adam) -> None:
    """Turn `opt`, whose parameters are on the card, into the Adam that a
    captured window steps, in place: `capturable`, its lr a device tensor,
    its step counts on the card; the moments stay. A window converts the
    state's optimizer when it captures. The capturable Adam computes its
    bias corrections on the device, so its updates can differ from the
    plain Adam's in the last bits; an eager step of a converted optimizer
    takes the window's update."""
    dev = opt.param_groups[0]["params"][0].device
    if dev.type != "cuda":
        raise ValueError(f"a capturable Adam needs parameters on the card, "
                         f"not on {dev}")
    for group in opt.param_groups:
        lr = group["lr"]
        if not (torch.is_tensor(lr) and lr.device == dev):
            group["lr"] = torch.full((), float(lr), device=dev)
        group["capturable"] = True
    for st in opt.state.values():
        if "step" in st:
            st["step"] = st["step"].to(device=dev, dtype=torch.float32)


def create_train_state(seed: int, mcfg: NeRFModelConfig, rcfg: RenderConfig,
                       tcfg: TrainConfig, device: DeviceLike = "cuda"
                       ) -> NeRFTrainState:
    """Coarse and fine parameters from one CPU generator seeded by `seed`
    (the fine net is the coarse one when there is no fine pass)."""
    gen = torch.Generator().manual_seed(seed)
    params = {"coarse": init_nerf_params(gen, mcfg, device)}
    params["fine"] = (init_nerf_params(gen, mcfg, device)
                      if rcfg.N_importance > 0 else params["coarse"])
    return NeRFTrainState(params, make_optimizer(tcfg, params), 0)


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse)


def precrop_window(H: int, W: int, precrop: bool, precrop_frac: float
                   ) -> Tuple[int, int, int, int]:
    """(y_lo, y_hi, x_lo, x_hi), half-open, of the pixels a step samples."""
    if not precrop:
        return 0, H, 0, W
    dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
    return H // 2 - dH, H // 2 + dH, W // 2 - dW, W // 2 + dW


def sample_rays(generator: torch.Generator, images: torch.Tensor,
                poses: torch.Tensor, K: torch.Tensor, n_rand: int,
                precrop: bool, precrop_frac: float, single_image: bool
                ) -> Batch:
    """N_rand rays and their target colours, drawn on the images' device.
    single_image=True is the reference's one-image-per-step regime
    (no_batching); False draws an image per ray."""
    n_img, H, W = images.shape[:3]
    dev = images.device
    y_lo, y_hi, x_lo, x_hi = precrop_window(H, W, precrop, precrop_frac)
    img = torch.randint(0, n_img, (1 if single_image else n_rand,),
                        generator=generator, device=dev).expand(n_rand)
    ys = torch.randint(y_lo, y_hi, (n_rand,), generator=generator, device=dev)
    xs = torch.randint(x_lo, x_hi, (n_rand,), generator=generator, device=dev)
    c2w = poses[img]                                          # [R, 4, 4]
    dirs = torch.stack([(xs.float() - K[0, 2]) / K[0, 0],
                        -(ys.float() - K[1, 2]) / K[1, 1],
                        -torch.ones(n_rand, device=dev)], dim=-1)
    rays_d = torch.sum(dirs[:, None, :] * c2w[:, :3, :3], dim=-1)
    return {"rays_o": c2w[:, :3, 3], "rays_d": rays_d,
            "target": images[img, ys, xs]}


def make_train_step(mcfg: NeRFModelConfig, rcfg: RenderConfig,
                    tcfg: TrainConfig, debug_numerics: bool = False,
                    mesh=None) -> Callable:
    """step_fn(state, batch, generator, image_hw) → metrics, updating the
    state's parameters and optimizer in place and advancing `state.step`.

    batch holds rays_o, rays_d, target and, optionally, t_rand / u_pdf;
    what it lacks is drawn from `generator`. `debug_numerics` adds a
    `finite` metric over the loss and maps (the reference's DEBUG check,
    run_nerf.py:414-416).

    With a `mesh` the state is `shard_train_state`'s and the batch is the
    whole batch (every rank passes the same one, drawn from the same
    generator): each rank renders its "data" rows on whole weights and the
    metrics are the whole batch's."""

    def step_fn(state: NeRFTrainState, batch: Batch,
                generator: Optional[torch.Generator],
                image_hw: Tuple[int, int], focal: float) -> Dict[str, Any]:
        with span("train.adam"):
            _set_lr(state.opt_state, tcfg, state.step)
            state.opt_state.zero_grad(set_to_none=True)
        metrics = _update(state, mcfg, rcfg, batch, generator, image_hw,
                          focal, debug_numerics, mesh)
        state.step += 1
        return metrics

    return step_fn


def _renderer_draws(generator: torch.Generator, rcfg: RenderConfig,
                    n_rays: int, device, have=()) -> Batch:
    """What render_rays(train=True) draws from `generator` for n_rays rays,
    drawn in its order (the stratified jitter, the coarse density noise,
    the inverse-CDF uniforms, the fine density noise), skipping the draws
    named in `have`, as the renderer skips injected ones."""
    perturb_on = rcfg.perturb > 0.0
    std = rcfg.raw_noise_std
    Ns, Ni = rcfg.N_samples, rcfg.N_importance
    order = [("t_rand", Ns, perturb_on, False),
             ("noise0", Ns, std > 0.0, True),
             ("u_pdf", Ni, Ni > 0 and perturb_on, False),
             ("noise1", Ns + Ni, Ni > 0 and std > 0.0, True)]
    out: Batch = {}
    for key, n, drawn, normal in order:
        if not drawn or key in have:
            continue
        fn = torch.randn if normal else torch.rand
        out[key] = fn((n_rays, n), generator=generator, dtype=torch.float32,
                      device=device)
        if normal:
            out[key] = out[key] * std
    return out


def _local_batch(mesh, batch: Batch, generator: Optional[torch.Generator],
                 rcfg: RenderConfig) -> Batch:
    """This rank's "data" rows of the whole batch, with the renderer's
    draws for the whole batch made first where the batch lacks them."""
    if generator is not None:
        batch = {**batch, **_renderer_draws(
            generator, rcfg, batch["rays_o"].shape[0],
            batch["rays_o"].device, have=batch.keys())}
    return {k: local_rows(v, mesh) for k, v in batch.items()}


def _whole_params(mesh, state: NeRFTrainState) -> Dict[str, Params]:
    """Whole parameters for the fused kernels: the state's own leaves when
    the model axis is 1 (gradients land in them), else all-gathered over
    "model" into fresh leaves."""
    if state.shapes is None:
        raise ValueError("a sharded step needs shard_train_state's state")
    if mesh.shape["model"] == 1:
        return state.params
    names = _leaf_names(state.params)
    got = gather_tensors(mesh, [(k, state.params[net][k],
                                 state.shapes[net][k]) for net, k in names])
    whole: Dict[str, Params] = {}
    for (net, k), t in zip(names, got):
        own = t is state.params[net][k]        # kept whole: the leaf itself
        whole.setdefault(net, {})[k] = t if own else t.requires_grad_(True)
    if state.params["fine"] is state.params["coarse"]:
        whole["fine"] = whole["coarse"]
    return whole


def _reduce_grads(mesh, state: NeRFTrainState, whole: Dict[str, Params],
                  extra: torch.Tensor) -> torch.Tensor:
    """Slice each whole gradient to this rank's shard into the shard's
    .grad, then all-reduce every gradient and `extra` over "data" in one
    flat buffer. Returns the reduced `extra`."""
    leaves = _leaves(state.params)
    grads = []
    for p, (net, k) in zip(leaves, _leaf_names(state.params)):
        w = whole[net][k]
        if w is not p:
            g = shard_tensor(mesh, k, w.grad)
            if p.grad is None:
                p.grad = g
            else:
                p.grad.copy_(g)
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = torch.cat([g.reshape(-1) for g in grads] + [extra.reshape(-1)])
    mesh.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset:]


def _update(state: NeRFTrainState, mcfg: NeRFModelConfig, rcfg: RenderConfig,
            batch: Batch, generator: Optional[torch.Generator],
            image_hw: Tuple[int, int], focal: float,
            debug_numerics: bool, mesh=None) -> Dict[str, torch.Tensor]:
    """One update, its learning rate set and its gradients zero or None:
    render coarse + fine, MSE, backward, Adam. Leaves `state.step`. With a
    `mesh`, this rank's rows of the whole batch on whole parameters, the
    gradients all-reduced over "data" before Adam updates the shards."""
    params, scale = state.params, 1.0
    if mesh is not None:
        n_whole = batch["rays_o"].shape[0]
        batch = _local_batch(mesh, batch, generator, rcfg)
        scale = batch["rays_o"].shape[0] / n_whole
        params = _whole_params(mesh, state)
        generator = None            # the batch holds every draw
    noise = None
    if "noise0" in batch:
        noise = (batch["noise0"], batch.get("noise1"))
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    viewdirs = near = far = None
    if rcfg.ndc:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        rays_o, rays_d = ndc_rays(image_hw[0], image_hw[1], focal, 1.0,
                                  rays_o, rays_d)
        near, far = 0.0, 1.0
    with span("train.render"):
        out = render_rays(
            params["coarse"], params["fine"], mcfg, rcfg,
            rays_o, rays_d, viewdirs=viewdirs, near=near, far=far,
            generator=generator, train=True, t_rand=batch.get("t_rand"),
            u_pdf=batch.get("u_pdf"), noise=noise)
    with span("train.backward"):
        loss_fine = img2mse(out["rgb_map"], batch["target"])
        if scale != 1.0:
            loss_fine = loss_fine * scale  # this rank's share of the mean
        loss = loss_fine
        if "rgb0" in out:
            loss_coarse = img2mse(out["rgb0"], batch["target"])
            if scale != 1.0:
                loss_coarse = loss_coarse * scale
            loss = loss + loss_coarse
        loss.backward()
    finite = None
    if debug_numerics:
        finite = torch.isfinite(loss)
        for k in ("rgb_map", "disp_map", "acc_map"):
            finite = finite & torch.isfinite(out[k]).all()
    loss, loss_fine = loss.detach(), loss_fine.detach()
    if mesh is not None:
        extra = [loss, loss_fine] + ([] if finite is None else
                                     [(~finite).to(loss.dtype)])
        reduced = _reduce_grads(mesh, state, params, torch.stack(extra))
        loss, loss_fine = reduced[0], reduced[1]
        if finite is not None:
            finite = reduced[2] == 0
    with span("train.adam"):
        state.opt_state.step()
    metrics = {"loss": loss, "psnr": mse2psnr(loss_fine)}
    if debug_numerics:
        metrics["finite"] = finite
    return metrics


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator in a run seeded by `seed`."""
    return seed * 1_000_003 + step


def make_multi_train_step(mcfg: NeRFModelConfig, rcfg: RenderConfig,
                          tcfg: TrainConfig, precrop: bool, k: int,
                          debug_numerics: bool = False,
                          mesh=None) -> Callable:
    """k train steps per call (the JAX trainer's `lax.scan`; the reference
    host-loops every step, run_nerf.py:727). Returns
    multi(state, images, poses, K, seed) → the last step's metrics: it
    runs steps state.step … state.step + k - 1, each drawing its rays
    from a generator seeded by step_seed(seed, i) as `train_nerf` does,
    so a windowed run draws what an unbroken one does, and advances
    `state.step` by k. `precrop` holds for the whole window: the caller
    picks windows that do not straddle `precrop_iters`.

    On the card the k steps are captured once as one CUDA graph and
    replayed for every window; a call with other shapes or another state
    captures anew and frees the graph it replaces. The capture makes the
    state's Adam capturable (`make_capturable`); one generator per step of
    the window is registered with the graph and reseeded on the host
    before each replay; the learning rate is computed in the graph from a
    device step counter; the gradients are zeroed in place. Before the
    capture one step runs on a side stream (lazy initialisation: Adam's
    moments, the kernels' tables), and the parameters and Adam's state are
    then put back as they were. The images, poses and K are copied into
    the graph's buffers on every call (pass tensors on the card). A
    capture that fails raises. On the CPU the same k-step program runs
    eagerly.

    With a `mesh` the state is `shard_train_state`'s and each step is
    make_train_step's sharded step; on the card the window captures its
    collectives (the gradient all-reduce, and the parameter all-gathers
    when the model axis is > 1) with the kernels, which NCCL allows and
    gloo does not: a gloo mesh on the card raises."""
    window: Optional[_Window] = None

    def multi(state: NeRFTrainState, images, poses, K, seed: int
              ) -> Dict[str, torch.Tensor]:
        nonlocal window
        dev = _leaves(state.params)[0].device
        images, poses, K = (torch.as_tensor(x, dtype=torch.float32,
                                            device=dev)
                            for x in (images, poses, K))
        hw = (images.shape[1], images.shape[2])
        focal = float(K[0, 0]) if rcfg.ndc else 0.0
        if dev.type != "cuda":
            gens = [torch.Generator(device=dev).manual_seed(
                step_seed(seed, state.step + i)) for i in range(k)]
            metrics = _window_program(state, mcfg, rcfg, tcfg, precrop, gens,
                                      images, poses, K, hw, focal,
                                      state.step, debug_numerics, mesh)
            state.step += k
            return metrics
        if mesh is not None and mesh.backend != "nccl":
            raise RuntimeError(
                f"a captured window needs NCCL collectives; the mesh's "
                f"{mesh.backend} backend cannot run inside a CUDA graph")
        key = (tuple(images.shape), tuple(poses.shape), focal)
        if (window is None or window.key != key
                or window.fingerprint != _fingerprint(state)):
            window = None          # frees the graph it replaces
            window = _Window.capture(state, mcfg, rcfg, tcfg, precrop, k,
                                     key, images, poses, K, hw, focal,
                                     debug_numerics, mesh)
        return window.replay(state, images, poses, K, seed)

    return multi


def _window_program(state: NeRFTrainState, mcfg: NeRFModelConfig,
                    rcfg: RenderConfig, tcfg: TrainConfig, precrop: bool,
                    gens, images: torch.Tensor, poses: torch.Tensor,
                    K: torch.Tensor, hw: Tuple[int, int], focal: float, step,
                    debug_numerics: bool, mesh=None
                    ) -> Dict[str, torch.Tensor]:
    """len(gens) updates, update i drawing from gens[i]. `step` is the
    first update's index: an int, or a float64 device counter that the
    program advances (the captured form)."""
    opt = state.opt_state
    metrics: Dict[str, torch.Tensor] = {}
    for i, gen in enumerate(gens):
        if torch.is_tensor(step):
            _set_lr(opt, tcfg, step)
            step.add_(1)
        else:
            _set_lr(opt, tcfg, step + i)
        opt.zero_grad(set_to_none=False)
        batch = sample_rays(gen, images, poses, K, tcfg.N_rand, precrop,
                            tcfg.precrop_frac, tcfg.no_batching)
        metrics = _update(state, mcfg, rcfg, batch, gen, hw, focal,
                          debug_numerics, mesh)
    return metrics


def _captured_tensors(state: NeRFTrainState) -> List[torch.Tensor]:
    """Every tensor of the state that a captured window reads or writes
    in place: parameters, gradients, Adam's moments, step counts and lr."""
    opt = state.opt_state
    out = [g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"])]
    for p in _leaves(state.params):
        out.append(p)
        if p.grad is not None:
            out.append(p.grad)
        out += [v for v in opt.state.get(p, {}).values() if torch.is_tensor(v)]
    return out


def _fingerprint(state: NeRFTrainState) -> tuple:
    return tuple(t.data_ptr() for t in _captured_tensors(state))


class _Window:
    """One captured window: the graph, its generators, its input buffers
    and step counter, the shapes it was captured for (`key`), and the
    tensors of the state it captured (held, so their memory stays theirs
    while the graph lives)."""

    def __init__(self, graph, gens, inputs, step, metrics, key, held):
        self.graph, self.gens, self.inputs = graph, gens, inputs
        self.step, self.metrics, self.key = step, metrics, key
        self.held = held
        self.fingerprint = tuple(t.data_ptr() for t in held)

    @staticmethod
    def capture(state, mcfg, rcfg, tcfg, precrop, k, key, images, poses, K,
                hw, focal, debug_numerics, mesh=None) -> "_Window":
        dev = images.device
        opt = state.opt_state
        make_capturable(opt)
        gens = [torch.Generator(device=dev) for _ in range(k)]
        inputs = tuple(x.clone() for x in (images, poses, K))
        step = torch.zeros((), dtype=torch.float64, device=dev)
        leaves = _leaves(state.params)
        with torch.no_grad():
            saved = [p.detach().clone() for p in leaves]
            moments = [{n: v.clone() for n, v in opt.state[p].items()}
                       if p in opt.state else None for p in leaves]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step.fill_(float(state.step))
            _window_program(state, mcfg, rcfg, tcfg, precrop, gens[:1],
                            *inputs, hw, focal, step, debug_numerics, mesh)
            with torch.no_grad():
                for p, v, m in zip(leaves, saved, moments):
                    p.copy_(v)
                    for n, t in opt.state[p].items():
                        if m is None:
                            t.zero_()
                        else:
                            t.copy_(m[n])
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            metrics = _window_program(state, mcfg, rcfg, tcfg, precrop, gens,
                                      *inputs, hw, focal, step,
                                      debug_numerics, mesh)
        return _Window(graph, gens, inputs, step, metrics, key,
                       _captured_tensors(state))

    def replay(self, state, images, poses, K, seed) -> Dict[str, torch.Tensor]:
        for buf, x in zip(self.inputs, (images, poses, K)):
            buf.copy_(x)
        for i, g in enumerate(self.gens):
            g.manual_seed(step_seed(seed, state.step + i))
        self.step.fill_(float(state.step))
        self.graph.replay()
        state.step += len(self.gens)
        return {n: v.clone() for n, v in self.metrics.items()}


def dump_run_config(logdir: str, cfg) -> None:
    """Write `args.txt` (flat `key = value` lines) and `config.json` into
    the run directory (the reference snapshots its flags per run,
    run_nerf.py:644-653)."""
    os.makedirs(logdir, exist_ok=True)
    d = dataclasses.asdict(cfg)
    with open(os.path.join(logdir, "args.txt"), "w") as f:
        for section, values in sorted(d.items()):
            if isinstance(values, dict):
                for k, v in sorted(values.items()):
                    f.write(f"{section}.{k} = {v}\n")
            else:
                f.write(f"{section} = {values}\n")
    with open(os.path.join(logdir, "config.json"), "w") as f:
        json.dump(d, f, indent=2, default=str)


def _state_dict(state: NeRFTrainState) -> Dict[str, Any]:
    return {"params": {k: dict(v) for k, v in state.params.items()},
            "opt_state": state.opt_state.state_dict(), "step": state.step}


def _restore(state: NeRFTrainState, path: str) -> None:
    ck = load_checkpoint(path)
    with torch.no_grad():
        for name in ("coarse", "fine"):
            for k, t in state.params[name].items():
                t.copy_(ck["params"][name][k])
    state.opt_state.load_state_dict(ck["opt_state"])
    state.step = int(ck["step"])


def load_train_state(path: str, cfg: ExperimentConfig,
                     device: DeviceLike = "cuda") -> NeRFTrainState:
    """The train state saved at `path` by `train_nerf`, on `device`."""
    state = create_train_state(0, cfg.model, cfg.render, cfg.train,
                               resolve_device(device))
    _restore(state, path)
    return state


def train_nerf(
    cfg: ExperimentConfig,
    images: np.ndarray,        # [N, H, W, 3] float32 targets (white-composited)
    poses: np.ndarray,         # [N, 4, 4]
    K: np.ndarray,
    i_train: np.ndarray,
    seed: int = 0,
    logdir: Optional[str] = None,
    n_iters: Optional[int] = None,
    log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
    test_render: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    spiral_poses: Optional[np.ndarray] = None,
    ft_path: Optional[str] = None,
    debug_numerics: bool = False,
    device: DeviceLike = "cuda",
    sampler: Optional[Callable[[int, bool], Batch]] = None,
    mesh=None,
) -> NeRFTrainState:
    """Train the coarse and fine NeRFs; the reference's train()
    (run_nerf.py:537-888) minus dataset loading.

    Resumes from `ft_path`, else from the latest checkpoint in `logdir`.
    Logs every `i_print` steps, checkpoints every `i_weights`, renders the
    test set every `i_testset` and a spiral every `i_video` steps.
    `sampler(step, precrop)`, when given, returns each step's batch (rays,
    targets and optionally the uniforms) in place of the drawn one.

    With a `mesh` (every rank calls this with the same arguments) the
    parameters and Adam moments are laid out over the "model" axis, each
    step's rays over "data", and the image feed is rank 0's on every rank
    (`replicate_global`); the device is `mesh.device`. Rank 0 writes the
    run config and the checkpoints, gathered to the one-device format,
    and the other ranks wait for it. The returned state is whole, as one
    device's would be."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.is_writer
    mcfg, rcfg, tcfg = cfg.model, cfg.render, cfg.train
    n_iters = n_iters or tcfg.N_iters
    if logdir and writer:
        dump_run_config(logdir, cfg)
    state = create_train_state(seed, mcfg, rcfg, tcfg, dev)
    ckpt = ft_path or (latest_checkpoint(logdir) if logdir else None)
    if ckpt:
        _restore(state, ckpt)
        print(f"[train] resumed from {ckpt} at step {state.step}")

    train_images = torch.as_tensor(np.asarray(images[i_train]),
                                   dtype=torch.float32, device=dev)
    train_poses = torch.as_tensor(np.asarray(poses[i_train]),
                                  dtype=torch.float32, device=dev)
    K_dev = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)
    if mesh is not None:
        from nerfail_tpu_torch.parallel.multihost import replicate_global

        state = shard_train_state(mesh, state)
        train_images, train_poses, K_dev = replicate_global(
            mesh, (train_images, train_poses, K_dev))

    def save(step: int) -> None:
        sd = (_state_dict(state) if mesh is None
              else _whole_state_dict(mesh, state))
        if writer:
            save_checkpoint(checkpoint_path(logdir, step), sd)
        if mesh is not None:
            mesh.barrier()

    def whole() -> NeRFTrainState:
        return state if mesh is None else gather_train_state(mesh, state)

    hw = tuple(train_images.shape[1:3])
    step_fn = make_train_step(mcfg, rcfg, tcfg, debug_numerics, mesh)
    gen = torch.Generator(device=dev)
    t0 = time.time()
    for i in range(state.step, n_iters):
        with span("train.step"):
            gen.manual_seed(step_seed(seed, i))
            precrop = i < tcfg.precrop_iters
            with span("train.batch"):
                if sampler is not None:
                    batch = {k: v.to(dev)
                             for k, v in sampler(i, precrop).items()}
                else:
                    batch = sample_rays(gen, train_images, train_poses,
                                        K_dev, tcfg.N_rand, precrop,
                                        tcfg.precrop_frac, tcfg.no_batching)
            metrics = step_fn(state, batch, gen, hw, float(K[0, 0]))
            if (debug_numerics and (i + 1) % tcfg.i_print == 0
                    and not bool(metrics["finite"])):
                raise FloatingPointError(
                    f"[Numerical Error] render output contains nan/inf at "
                    f"step {i + 1}")
            if log_fn is not None and (i + 1) % tcfg.i_print == 0:
                with span("train.log"):
                    m = {k: float(v) for k, v in metrics.items()}
                    m["steps_per_s"] = tcfg.i_print / max(time.time() - t0,
                                                          1e-9)
                    t0 = time.time()
                    log_fn(i + 1, m)
            if logdir and (i + 1) % tcfg.i_weights == 0:
                save(i + 1)
            if test_render is not None and (i + 1) % tcfg.i_testset == 0:
                test_imgs, test_poses = test_render
                psnr = eval_psnr(whole(), cfg, test_imgs, test_poses, K,
                                 np.arange(min(len(test_poses), 8)))
                if log_fn is not None:
                    log_fn(i + 1, {"testset_psnr": psnr})
            if (logdir and spiral_poses is not None
                    and (i + 1) % tcfg.i_video == 0):
                from nerfail_tpu_torch.render_path import render_path

                params = whole().params
                if writer:
                    render_path(params, cfg, spiral_poses, hw[0], hw[1],
                                np.asarray(K), video_path=os.path.join(
                                    logdir, f"spiral_{i + 1:06d}.mp4"))
    state.step = max(state.step, n_iters)
    if logdir:
        save(n_iters)
    return whole()


def eval_psnr(state: NeRFTrainState, cfg: ExperimentConfig,
              images: np.ndarray, poses: np.ndarray, K: np.ndarray,
              idxs: np.ndarray) -> float:
    """Mean PSNR of full renders of the poses `idxs` against their images
    (the reference prints this at i_testset)."""
    H, W = images.shape[1:3]
    total = 0.0
    for i in idxs:
        out = render_full_image(state.params["coarse"], state.params["fine"],
                                cfg.model, cfg.render, H, W, K, poses[i])
        target = torch.as_tensor(np.asarray(images[i]), dtype=torch.float32,
                                 device=out["rgb_map"].device)
        mse = float(torch.mean((out["rgb_map"] - target) ** 2))
        total += -10.0 * np.log10(mse)
    return total / len(idxs)
