"""Engine `nerf_train`: `train_nerf` at the cell's configuration.

Set-up makes the views and poses on the card from the seed and starts
`train_nerf`, which builds the train state and takes its first
`log_every` steps (kernel builds, allocator and cuBLAS warm-up). The
window runs from the first `log_fn` call to the first one after
`--seconds`; both points end in the trainer's own host sync
(`float(loss)`). Then the trainer is stopped by an exception from
`log_fn`. The rays come from the benchmark's sampler (`scene.RaySampler`)
through `train_nerf`'s `sampler` argument, so the reference sees the
same batches: the port's own ray sampler is outside the window.

The readings that decide `correct` are of the window's own object and
call: the first `checked_steps` steps of that same `train_nerf`. Each
step's loss is read where `train_nerf` computes it (`img2mse`, wrapped
for those steps only), the first gradient from Adam's first moment after
one step, and the parameters before the first step and after the last
through the optimizer's step hooks, which are removed before the window.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch
from torch.optim.optimizer import (
    register_optimizer_step_post_hook, register_optimizer_step_pre_hook,
)

from benchmark import scene
from benchmark.drivers.nerf_common import median, norm_gap, program_config
from benchmark.harness import Check, Context
from benchmark.reference import nerf as ref
from nerfail_tpu_torch.train import nerf_trainer

RIG_STREAM = 1


class WindowClosed(Exception):
    pass


class Readings:
    """The program's losses, first gradient and parameters over its first
    n steps, read through hooks that touch no value."""

    def __init__(self, n: int):
        self.n = n
        self.losses: List[float] = []
        self.grads: Optional[List[torch.Tensor]] = None
        self.p0: Optional[List[torch.Tensor]] = None
        self.pn: Optional[List[torch.Tensor]] = None
        self._parts: List[torch.Tensor] = []
        self._steps = 0
        self._handles = []
        self._img2mse = None

    def install(self) -> None:
        self._handles = [register_optimizer_step_pre_hook(self._pre),
                         register_optimizer_step_post_hook(self._post)]
        self._img2mse = nerf_trainer.img2mse

        def img2mse(x, y):
            out = self._img2mse(x, y)
            self._parts.append(out.detach().clone())
            return out

        nerf_trainer.img2mse = img2mse

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
        if self._img2mse is not None:
            nerf_trainer.img2mse = self._img2mse
            self._img2mse = None

    def _params(self, opt) -> List[torch.Tensor]:
        return [p for g in opt.param_groups for p in g["params"]]

    def _pre(self, opt, args, kwargs) -> None:
        if self._steps == 0:
            self.p0 = [p.detach().clone() for p in self._params(opt)]

    def _post(self, opt, args, kwargs) -> None:
        self._steps += 1
        # the loss is the fine and the coarse MSE of this step
        self.losses.append(float(sum(self._parts[-2:])))
        self._parts.clear()
        if self._steps == 1:
            b1 = opt.param_groups[0]["betas"][0]
            self.grads = [opt.state[p]["exp_avg"].detach().clone() / (1 - b1)
                          for p in self._params(opt)]
        if self._steps == self.n:
            self.pn = [p.detach().clone() for p in self._params(opt)]
            self.remove()


def make_inputs(ctx: Context):
    cfg = ctx.cfg
    sc = cfg["scene"]
    rig = scene.make_rig(sc, sc["n_train"], ctx.seed, RIG_STREAM, ctx.device)
    images = scene.render_box(rig, sc, ctx.seed)
    sampler = scene.RaySampler(rig, images, cfg["train"], cfg["render"],
                               ctx.seed)
    return rig, images, sampler


def measure(ctx: Context, tracer=None) -> None:
    cfg, traffic = ctx.cfg, ctx.traffic
    pcfg = program_config(cfg)
    log_every = traffic["log_every"]
    if pcfg.train.i_print != log_every:
        raise ValueError("the window's boundaries are the trainer's logs")
    rig, images, sampler = make_inputs(ctx)
    ctx.mark("inputs made")
    readings = Readings(traffic["checked_steps"])
    ctx.keep["readings"] = readings
    marks = {}

    def log_fn(step: int, metrics) -> None:
        now = time.perf_counter()
        if "t0" not in marks:
            marks["t0"], marks["step0"] = now, step
            ctx.mark(f"{step} steps trained")
            ctx.stats["setup_end"] = now
            if tracer is not None:
                tracer.start()
            return
        marks.setdefault("logs", []).append(now)
        done = (step - marks["step0"]) // log_every
        if (tracer is not None and done >= traffic["traced_intervals"]) or (
                tracer is None and now - marks["t0"] >= ctx.seconds):
            if tracer is not None:
                tracer.stop()
            marks["t1"], marks["step1"] = now, step
            raise WindowClosed

    def sample(i, precrop):
        if i in (1, readings.n):
            ctx.mark(f"step {i} started")
        return sampler(i, precrop)

    readings.install()
    try:
        nerf_trainer.train_nerf(
            pcfg, images.cpu().numpy(), rig.poses.cpu().numpy(),
            rig.K.cpu().numpy(), np.arange(images.shape[0]), seed=ctx.seed,
            n_iters=pcfg.train.N_iters, log_fn=log_fn, device=ctx.device,
            sampler=sample)
        raise RuntimeError("train_nerf ended before the window closed")
    except WindowClosed:
        pass
    finally:
        readings.remove()
    steps = marks["step1"] - marks["step0"]
    window = marks["t1"] - marks["t0"]
    n_rays = cfg["train"]["N_rand"]
    ctx.attempted, ctx.failed = steps, 0
    ctx.stats.update(steps=steps, window_s=window, n_rays=n_rays)
    logs = [marks["t0"]] + marks["logs"]
    # seconds of each logging interval of the window, to show how the
    # rate moves inside a run
    ctx.stats.setdefault("info", {})["interval_s"] = [
        round(b - a, 4) for a, b in zip(logs, logs[1:])]
    ctx.e2e["train_rays_per_s"] = n_rays * steps / window


def first_steps(ctx: Context, sampler_wrap=None) -> dict:
    """The program's readings of its first `checked_steps` steps alone:
    `train_nerf` for that many steps, with no window."""
    pcfg = program_config(ctx.cfg)
    rig, images, sampler = make_inputs(ctx)
    if sampler_wrap is not None:
        sampler = sampler_wrap(sampler)
    readings = Readings(ctx.traffic["checked_steps"])
    readings.install()
    try:
        nerf_trainer.train_nerf(
            pcfg, images.cpu().numpy(), rig.poses.cpu().numpy(),
            rig.K.cpu().numpy(), np.arange(images.shape[0]), seed=ctx.seed,
            n_iters=readings.n, device=ctx.device, sampler=sampler)
    finally:
        readings.remove()
    return {"losses": readings.losses, "grads": readings.grads,
            "p0": readings.p0, "pn": readings.pn}


def reference_readings(ctx: Context, mm=ref.f32_mm, loss_rows=None):
    """The reference's readings over the same first steps: its losses,
    first gradient, and parameters before and after."""
    cfg = ctx.cfg
    _, _, sampler = make_inputs(ctx)
    n = ctx.traffic["checked_steps"]
    precrop = cfg["train"]["precrop_iters"]
    batches = [sampler(i, i < precrop) for i in range(n)]
    nets = ref.init_params(ctx.seed, cfg["model"], ctx.device)
    p0 = [p.detach().clone() for p in ref.leaves_of(nets)]
    out = ref.train_steps(nets, cfg["model"], cfg["render"], cfg["train"],
                          batches, mm=mm, loss_rows=loss_rows)
    out["p0"] = p0
    out["pn"] = [p.detach().clone() for p in ref.leaves_of(nets)]
    return out


def compare(prog, refr) -> List[float]:
    """(loss_gap, grad_gap, change_gap) of the program's readings `prog`
    (losses, grads, p0, pn) against the reference's: the worst step's
    loss gap, the median leaf's first-gradient gap and the worst counted
    leaf's change gap, each relative."""
    if prog["grads"] is None or prog["pn"] is None or len(
            prog["losses"]) != len(refr["losses"]):
        return [float("inf")] * 3
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], refr["losses"]))
    # the median leaf: the worst is one small leaf's rounding (alpha_b,
    # one entry), which reads as far from seed to seed as the control
    grad_gap = norm_gap(prog["grads"], refr["grads"], worst=False)
    gn = [float(torch.linalg.vector_norm(g)) for g in refr["grads"]]
    med = median(gn)
    # leaves whose reference gradient is nought to rounding move under
    # Adam by round-off alone: left out of the change by this rule
    counted = [g >= 1e-3 * med for g in gn]
    change_gap = norm_gap([b - a for a, b in zip(prog["p0"], prog["pn"])],
                          [b - a for a, b in zip(refr["p0"], refr["pn"])],
                          counted)
    return [loss_gap, grad_gap, change_gap]


def check(ctx: Context) -> List[Check]:
    r = ctx.keep.pop("readings")
    prog = {"losses": r.losses, "grads": r.grads, "p0": r.p0, "pn": r.pn}
    gaps = compare(prog, reference_readings(ctx))
    names = ("loss_gap", "grad_gap", "change_gap")
    return [Check(n, v, ctx.limit(n)) for n, v in zip(names, gaps)]

