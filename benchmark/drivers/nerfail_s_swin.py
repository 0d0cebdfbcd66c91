"""Engine `nerfail_s_swin`: the NeRFail-S cell of engine `nerfail_s` with
Swin-B in Inception-V3's place, as NeRFail's `GetModel` loads it
(torchvision's swin_b, 8 classes, at 299x299).

The views, coordinates, point set, 8-NN tables, attack, plan cache,
window, epochs, `setup_s` and the traced run's `k1_bytes` are those of
`nerfail_s`. The classifier is the program's `SwinB(num_classes,
image_size=input_size)` at the configuration's widths, with weights drawn
on the card from the seed (`swin_state`); it has no batch norm, so
nothing is calibrated. It is built first, so that a program that cannot
build it fails at once.

The check is `nerfail_s`'s (`step_sign_miss`, `knn_dist_gap`,
`knn_weight_gap`) with the plain reference's Swin-B, and two gaps of the
classifier alone on the checked call's attacked batch, recorded from the
timed call's own `logits_fn`: `logit_gap`, the program's logits against
the reference's on the same classifier input, and `grad_gap`, the
gradient of the step's loss at that input (the classifier's backward)
against the reference's autograd of the same loss; each the largest
absolute difference over the largest absolute reference value.
"""

from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

import torch.nn.functional as F

from benchmark.attack_scene import WEIGHT_STREAM
from benchmark.counts import attack as counts
from benchmark.drivers.nerfail_s import (
    CHECKS, Recorder, Tables, WindowClosed, attack_config, checked_steps,
    delta0_of, make_inputs, recorded_views, reference_step, step_miss,
    table_gaps,
)
from benchmark.harness import Check, Context
from benchmark.reference.swin_b import SwinB as RefSwinB
from benchmark.reference.swin_b import fp32
from benchmark.scene import generator
from nerfail_tpu_torch.attacks import nerfail_s
from nerfail_tpu_torch.attacks.forward import make_classifier_logits_fn
from nerfail_tpu_torch.config import PointSetConfig
from nerfail_tpu_torch.models.classifiers.swin import SwinB
from nerfail_tpu_torch.pointset.extract import build_neighbor_tables


def widths(c: dict) -> dict:
    """The program's SwinB arguments; its MLP ratio is 4, the reference's
    is the configuration's."""
    return {k: c[k] for k in ("embed_dim", "depths", "num_heads", "window")}


def swin_state(model: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for `model` from one draw on the device: linear layers
    of std 1 / sqrt(fan_in) and zero bias, the patch convolution He-normal
    (std sqrt(2 / fan_in)), LayerNorm scale 1 and shift 0, and the
    relative-position bias tables of std 0.02."""
    state = model.state_dict()
    keys = [k for k, v in state.items() if k.endswith("rel_pos_bias")
            or (k.endswith(".weight") and v.dim() in (2, 4))]
    sizes = [state[k].numel() for k in keys]
    flat = torch.randn(sum(sizes), device=device,
                       generator=generator(seed, device, WEIGHT_STREAM))
    out = {}
    for k, v in state.items():
        out[k] = (torch.ones_like(v) if k.endswith(".weight") and v.dim() == 1
                  else torch.zeros_like(v)).to(device)
    for k, part in zip(keys, torch.split(flat, sizes)):
        w = state[k]
        if k.endswith("rel_pos_bias"):
            std = 0.02
        else:
            std = math.sqrt((2.0 if w.dim() == 4 else 1.0) / w[0].numel())
        out[k] = (part * std).view(w.shape)
    return out


def reference_model(ctx: Context, state: dict) -> RefSwinB:
    c = ctx.cfg["classifier"]
    model = RefSwinB(c["num_classes"], c["input_size"],
                     mlp_ratio=c["mlp_ratio"], **widths(c)).to(ctx.device)
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


class ClassifierRecorder:
    """The attack's `logits_fn`, keeping, for the first call inside each of
    the recorder's chosen step calls (the attacked batch:
    `splat_attack_forward` classifies it before the clean one), its input,
    its logits and the gradient of the step's loss at its input."""

    def __init__(self, fn, rec: Recorder):
        self.fn, self.rec, self.records = fn, rec, []

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = self.fn(x)
        call = self.rec.n - 1
        if call in self.rec.calls and call not in {r["call"] for r in
                                                   self.records}:
            r = {"call": call, "x": x.detach().clone(),
                 "logits": out.detach().clone(), "grad": None}
            if x.requires_grad:
                x.register_hook(lambda g: r.update(grad=g.detach().clone()))
            self.records.append(r)
        return out


def measure(ctx: Context, tracer=None) -> None:
    cfg = ctx.cfg
    dev = ctx.device
    c = cfg["classifier"]
    model = SwinB(c["num_classes"], image_size=c["input_size"],
                  **widths(c)).to(dev)
    state = swin_state(model, ctx.seed, dev)
    model.load_state_dict(state)
    ctx.mark("classifier loaded")
    K, poses, rgba, coords, S = make_inputs(ctx)
    ctx.mark("views made")
    pc = cfg["pointset"]
    weights, idx = build_neighbor_tables(
        coords, S.cpu().numpy(),
        PointSetConfig(k=pc["k"], gauss_c=pc["gauss_c"],
                       gauss_eps=pc["gauss_eps"]), device=dev)
    del coords
    ctx.mark("tables built")
    ori = rgba.cpu().numpy()
    delta0 = delta0_of(cfg, rgba)
    del rgba
    n = ori.shape[0]
    acfg = attack_config(cfg)
    n_batches = -(-n // acfg.batch_size)
    picks = checked_steps(ctx, n_batches)
    rec = Recorder([n_batches + p for p in picks])
    logits_fn = ClassifierRecorder(make_classifier_logits_fn(model), rec)
    labels = np.full(n, cfg["attack"]["label"], np.int64)
    marks = {}

    def log_fn(epoch, entry):
        now = time.perf_counter()
        if epoch == 0:
            marks["t0"] = now
            ctx.stats["setup_end"] = now
            ctx.mark("epoch 0 (plans, plan cache)")
            if tracer is not None:
                tracer.start()
            return
        marks["epochs"] = epoch
        if (tracer is not None) or now - marks["t0"] >= ctx.seconds:
            if tracer is not None:
                tracer.stop()
            marks["t1"] = now
            raise WindowClosed

    make = nerfail_s.make_nerfail_s_step
    nerfail_s.make_nerfail_s_step = rec.wrap(make)
    try:
        nerfail_s.nerfail_s_attack(
            delta0, weights, idx, ori, labels, logits_fn, acfg,
            resize_to=c["input_size"], log_fn=log_fn, epochs=1 << 30,
            plan_device_budget=cfg["plan_device_budget"], device=dev)
        raise RuntimeError("the attack ended before the window closed")
    except WindowClosed:
        pass
    finally:
        nerfail_s.make_nerfail_s_step = make
    epochs = marks["epochs"]
    window = marks["t1"] - marks["t0"]
    ctx.attempted, ctx.failed = n * epochs, 0
    ctx.stats.update(epochs=epochs, views=n * epochs, window_s=window,
                     n_batches=n_batches)
    ctx.e2e["nerfail_s_views_per_s"] = n * epochs / window
    if tracer is not None:
        ctx.stats["k1_bytes"] = epochs * sum(
            counts.k1_bytes(**counts.batch_plan_sizes(
                torch.from_numpy(idx[s:s + acfg.batch_size]).to(dev),
                torch.from_numpy(ori[s:s + acfg.batch_size, ..., 3]).to(dev)))
            for s in range(0, n, acfg.batch_size))
    ctx.keep.update(records=rec.records, logits=logits_fn.records,
                    weights=weights, idx=idx, ori=ori, delta0=delta0,
                    classifier=state, labels=labels)


def classifier_gaps(ctx: Context, model, records, labels) -> List[float]:
    """(logit_gap, grad_gap) over the recorded attacked batches: the
    program's logits and input gradient against the reference's on the
    same input, the gradient that of the step's loss (cross-entropy over
    the batch's views, the mean over those in the attack)."""
    bs, n_views = ctx.cfg["attack"]["batch_size"], labels.shape[0]
    gaps = [[0.0, 0.0], [0.0, 0.0]]             # [num, den] a gap
    for r in records:
        if r["grad"] is None:
            return [float("inf")] * 2
        s = (r["call"] % ctx.stats["n_batches"]) * bs
        n = min(bs, n_views - s)
        x = r["x"].requires_grad_(True)
        logits = model(x)
        y = torch.from_numpy(labels[s:s + n]).to(x.device)
        loss = F.cross_entropy(logits[:n], y, reduction="sum") / n
        (g,) = torch.autograd.grad(loss, x)
        for gap, p, q in zip(gaps, (r["logits"], r["grad"]),
                             (logits.detach(), g)):
            gap[0] = max(gap[0], float((p - q).abs().max()))
            gap[1] = max(gap[1], float(q.abs().max()))
    return [num / den if den > 0 else float("inf") for num, den in gaps]


@fp32()
def check(ctx: Context) -> List[Check]:
    st = ctx.keep
    model = reference_model(ctx, st["classifier"])
    tables = Tables(ctx, recorded_views(ctx, st))
    miss = 0.0
    for call, before, after in st["records"]:
        ref_out = reference_step(ctx, st, model, call, before, tables)
        miss = max(miss, step_miss(after, ref_out, before))
    want = ctx.traffic["checked_steps"]
    if len(st["records"]) != want:
        miss = float("inf")
    gaps = (classifier_gaps(ctx, model, st["logits"], st["labels"])
            if len(st["logits"]) == want else [float("inf")] * 2)
    v = tables.views
    vals = [miss] + table_gaps(tables, torch.from_numpy(st["weights"][v]),
                               torch.from_numpy(st["idx"][v])) + gaps
    st.clear()
    return [Check(n, v, ctx.limit(n))
            for n, v in zip(CHECKS + ("logit_gap", "grad_gap"), vals)]
