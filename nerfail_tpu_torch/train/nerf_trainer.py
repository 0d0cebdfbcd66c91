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
with a float learning rate. The JAX trainer's `mesh` waits for the
multi-GPU port.
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
from nerfail_tpu_torch.render import render_full_image, render_rays
from nerfail_tpu_torch.train.checkpoint import (
    checkpoint_path,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]


@dataclass
class NeRFTrainState:
    params: Dict[str, Params]        # {"coarse": ..., "fine": ...}
    opt_state: torch.optim.Optimizer  # Adam over every distinct leaf
    step: int


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
                    tcfg: TrainConfig, debug_numerics: bool = False
                    ) -> Callable:
    """step_fn(state, batch, generator, image_hw) → metrics, updating the
    state's parameters and optimizer in place and advancing `state.step`.

    batch holds rays_o, rays_d, target and, optionally, t_rand / u_pdf;
    what it lacks is drawn from `generator`. `debug_numerics` adds a
    `finite` metric over the loss and maps (the reference's DEBUG check,
    run_nerf.py:414-416)."""

    def step_fn(state: NeRFTrainState, batch: Batch,
                generator: Optional[torch.Generator],
                image_hw: Tuple[int, int], focal: float) -> Dict[str, Any]:
        _set_lr(state.opt_state, tcfg, state.step)
        state.opt_state.zero_grad(set_to_none=True)
        metrics = _update(state, mcfg, rcfg, batch, generator, image_hw,
                          focal, debug_numerics)
        state.step += 1
        return metrics

    return step_fn


def _update(state: NeRFTrainState, mcfg: NeRFModelConfig, rcfg: RenderConfig,
            batch: Batch, generator: Optional[torch.Generator],
            image_hw: Tuple[int, int], focal: float,
            debug_numerics: bool) -> Dict[str, torch.Tensor]:
    """One update, its learning rate set and its gradients zero or None:
    render coarse + fine, MSE, backward, Adam. Leaves `state.step`."""
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    viewdirs = near = far = None
    if rcfg.ndc:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        rays_o, rays_d = ndc_rays(image_hw[0], image_hw[1], focal, 1.0,
                                  rays_o, rays_d)
        near, far = 0.0, 1.0
    out = render_rays(
        state.params["coarse"], state.params["fine"], mcfg, rcfg,
        rays_o, rays_d, viewdirs=viewdirs, near=near, far=far,
        generator=generator, train=True, t_rand=batch.get("t_rand"),
        u_pdf=batch.get("u_pdf"))
    loss_fine = img2mse(out["rgb_map"], batch["target"])
    loss = loss_fine
    if "rgb0" in out:
        loss = loss + img2mse(out["rgb0"], batch["target"])
    loss.backward()
    state.opt_state.step()
    metrics = {"loss": loss.detach(), "psnr": mse2psnr(loss_fine.detach())}
    if debug_numerics:
        finite = torch.isfinite(loss)
        for k in ("rgb_map", "disp_map", "acc_map"):
            finite = finite & torch.isfinite(out[k]).all()
        metrics["finite"] = finite
    return metrics


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator in a run seeded by `seed`."""
    return seed * 1_000_003 + step


def make_multi_train_step(mcfg: NeRFModelConfig, rcfg: RenderConfig,
                          tcfg: TrainConfig, precrop: bool, k: int,
                          debug_numerics: bool = False) -> Callable:
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
    eagerly."""
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
                                      state.step, debug_numerics)
            state.step += k
            return metrics
        key = (tuple(images.shape), tuple(poses.shape), focal)
        if (window is None or window.key != key
                or window.fingerprint != _fingerprint(state)):
            window = None          # frees the graph it replaces
            window = _Window.capture(state, mcfg, rcfg, tcfg, precrop, k,
                                     key, images, poses, K, hw, focal,
                                     debug_numerics)
        return window.replay(state, images, poses, K, seed)

    return multi


def _window_program(state: NeRFTrainState, mcfg: NeRFModelConfig,
                    rcfg: RenderConfig, tcfg: TrainConfig, precrop: bool,
                    gens, images: torch.Tensor, poses: torch.Tensor,
                    K: torch.Tensor, hw: Tuple[int, int], focal: float, step,
                    debug_numerics: bool) -> Dict[str, torch.Tensor]:
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
                          debug_numerics)
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
                hw, focal, debug_numerics) -> "_Window":
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
                            *inputs, hw, focal, step, debug_numerics)
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
                                      debug_numerics)
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
) -> NeRFTrainState:
    """Train the coarse and fine NeRFs; the reference's train()
    (run_nerf.py:537-888) minus dataset loading.

    Resumes from `ft_path`, else from the latest checkpoint in `logdir`.
    Logs every `i_print` steps, checkpoints every `i_weights`, renders the
    test set every `i_testset` and a spiral every `i_video` steps.
    `sampler(step, precrop)`, when given, returns each step's batch (rays,
    targets and optionally the uniforms) in place of the drawn one."""
    dev = resolve_device(device)
    mcfg, rcfg, tcfg = cfg.model, cfg.render, cfg.train
    n_iters = n_iters or tcfg.N_iters
    if logdir:
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
    hw = tuple(train_images.shape[1:3])
    step_fn = make_train_step(mcfg, rcfg, tcfg, debug_numerics)
    gen = torch.Generator(device=dev)
    t0 = time.time()
    for i in range(state.step, n_iters):
        gen.manual_seed(step_seed(seed, i))
        precrop = i < tcfg.precrop_iters
        if sampler is not None:
            batch = {k: v.to(dev) for k, v in sampler(i, precrop).items()}
        else:
            batch = sample_rays(gen, train_images, train_poses, K_dev,
                                tcfg.N_rand, precrop, tcfg.precrop_frac,
                                tcfg.no_batching)
        metrics = step_fn(state, batch, gen, hw, float(K[0, 0]))
        if (debug_numerics and (i + 1) % tcfg.i_print == 0
                and not bool(metrics["finite"])):
            raise FloatingPointError(
                f"[Numerical Error] render output contains nan/inf at "
                f"step {i + 1}")
        if log_fn is not None and (i + 1) % tcfg.i_print == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_s"] = tcfg.i_print / max(time.time() - t0, 1e-9)
            t0 = time.time()
            log_fn(i + 1, m)
        if logdir and (i + 1) % tcfg.i_weights == 0:
            save_checkpoint(checkpoint_path(logdir, i + 1), _state_dict(state))
        if test_render is not None and (i + 1) % tcfg.i_testset == 0:
            test_imgs, test_poses = test_render
            psnr = eval_psnr(state, cfg, test_imgs, test_poses, K,
                             np.arange(min(len(test_poses), 8)))
            if log_fn is not None:
                log_fn(i + 1, {"testset_psnr": psnr})
        if logdir and spiral_poses is not None and (i + 1) % tcfg.i_video == 0:
            from nerfail_tpu_torch.render_path import render_path

            render_path(state.params, cfg, spiral_poses, hw[0], hw[1],
                        np.asarray(K), video_path=os.path.join(
                            logdir, f"spiral_{i + 1:06d}.mp4"))
    state.step = max(state.step, n_iters)
    if logdir:
        save_checkpoint(checkpoint_path(logdir, n_iters), _state_dict(state))
    return state


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
