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
and uniforms). The JAX trainer's `make_multi_train_step` (k steps in one
`lax.scan`) is a plain loop here, and its `mesh` waits for the multi-GPU
port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

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
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        viewdirs = near = far = None
        if rcfg.ndc:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            rays_o, rays_d = ndc_rays(image_hw[0], image_hw[1], focal, 1.0,
                                      rays_o, rays_d)
            near, far = 0.0, 1.0
        opt = state.opt_state
        for group in opt.param_groups:
            group["lr"] = lr_at(tcfg, state.step)
        opt.zero_grad(set_to_none=True)
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
        opt.step()
        state.step += 1
        metrics = {"loss": loss.detach(), "psnr": mse2psnr(loss_fine.detach())}
        if debug_numerics:
            finite = torch.isfinite(loss)
            for k in ("rgb_map", "disp_map", "acc_map"):
                finite = finite & torch.isfinite(out[k]).all()
            metrics["finite"] = finite
        return metrics

    return step_fn


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
        gen.manual_seed(seed * 1_000_003 + i)
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
