"""Engine `nerfail_s`: `attacks.nerfail_s.nerfail_s_attack` over every view
of the cell, as `Pipeline.stage_attack` runs it.

Set-up makes the views, their coordinates and the point set of the mask
views on the card from the seed, builds the 8-NN tables with the port's
`pointset.extract.build_neighbor_tables` (K3) into host arrays, where
`Pipeline.stage_attack` keeps them, and loads the seeded Inception-V3.
Epoch 0 builds every batch's plan and fills the plan cache (its device
budget, then pinned host copies); it is set-up too. The window runs from
the end of epoch 0 to the first epoch end after `--seconds`; each epoch
end waits for the card (the attack's `tolist()` of its counts).

The check follows the program step by step: `checked_steps` steps of the
window's first epoch, drawn from the seed, are recorded where the attack
makes them (its step function, wrapped), and the plain reference takes
the same step from the program's perturbation, with 8-NN tables of those
steps' views that it works out again from the inputs by its own exact
search. The program's tables of the same views are compared with the
reference's on every foreground pixel.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from benchmark import attack_scene
from benchmark.counts import attack as counts
from benchmark.harness import Check, Context
from benchmark.reference import attack as ref
from benchmark.reference.inception_v3 import InceptionV3 as RefInception
from benchmark.reference.inception_v3 import calibrate
from benchmark.scene import sub_seed
from nerfail_tpu_torch.attacks import nerfail_s
from nerfail_tpu_torch.attacks.forward import make_classifier_logits_fn
from nerfail_tpu_torch.config import AttackConfig, PointSetConfig
from nerfail_tpu_torch.models.classifiers.inception_v3 import InceptionV3
from nerfail_tpu_torch.pointset.extract import build_neighbor_tables

CHECK_STREAM = 24
CHECKS = ("step_sign_miss", "knn_dist_gap", "knn_weight_gap")


class WindowClosed(Exception):
    pass


def make_inputs(ctx: Context):
    """(K, poses, uint8 RGBA views, coordinates, point set) on the card."""
    sc = ctx.cfg["scene"]
    K, poses = attack_scene.rig(sc, ctx.seed, ctx.device)
    rgba, coords = attack_scene.views(sc, K, poses, ctx.seed)
    mask = list(ctx.cfg["pointset"]["mask_views"])
    return K, poses, rgba, coords, coords[mask].reshape(-1, 3)


def white(rgba: torch.Tensor) -> torch.Tensor:
    rgb = rgba[..., :3].float()
    return torch.where(rgba[..., 3:] > 0, rgb, torch.full_like(rgb, 255.0))


def classifier_state(ctx: Context, rgba: torch.Tensor) -> dict:
    """The seeded weights with running statistics calibrated on the first
    clean views, by the reference's model."""
    c = ctx.cfg["classifier"]
    model = RefInception(c["num_classes"], c["aux_logits"]).to(ctx.device)
    model.load_state_dict(attack_scene.classifier_state(model, ctx.seed,
                                                        ctx.device))
    x = ref.resize(white(rgba[:c["calibration_views"]]), c["input_size"])
    calibrate(model, x)
    return model.state_dict()


def attack_config(cfg: dict) -> AttackConfig:
    a = cfg["attack"]
    return AttackConfig(method=a["method"], eps=a["eps"], a=a["a"],
                        m1=a["m1"], m2=a["m2"], batch_size=a["batch_size"],
                        overshoot=a["overshoot"], beta=a["beta"],
                        base_mask_number=a["base_mask_number"],
                        df_max_iter=a["df_max_iter"])


def delta0_of(cfg: dict, rgba: torch.Tensor) -> np.ndarray:
    """Zero RGB with the mask views' alpha (zero_init_mask)."""
    m = rgba[list(cfg["pointset"]["mask_views"])].float()
    return torch.cat([torch.zeros_like(m[..., :3]), m[..., 3:]],
                     -1).cpu().numpy()


def checked_steps(ctx: Context, n_batches: int) -> List[int]:
    """Indices (within the window's first epoch) of the steps to check."""
    gen = torch.Generator().manual_seed(sub_seed(ctx.seed, CHECK_STREAM))
    k = min(ctx.traffic["checked_steps"], n_batches)
    return sorted(int(i) for i in torch.randperm(n_batches, generator=gen)[:k])


class Recorder:
    """Wraps the attack's step function and keeps the perturbation before
    and after the chosen calls, and the batch each one took."""

    def __init__(self, calls):
        self.calls, self.n, self.records = set(calls), 0, []

    def wrap(self, make):
        def make_step(*args, **kwargs):
            step = make(*args, **kwargs)

            def recorded(delta, *rest):
                i = self.n
                self.n += 1
                out = step(delta, *rest)
                if i in self.calls:
                    self.records.append((i, delta.detach().clone(),
                                         out[0].detach().clone()))
                return out

            return recorded

        return make_step


def measure(ctx: Context, tracer=None) -> None:
    cfg = ctx.cfg
    dev = ctx.device
    K, poses, rgba, coords, S = make_inputs(ctx)
    ctx.mark("views made")
    pc = cfg["pointset"]
    weights, idx = build_neighbor_tables(
        coords, S.cpu().numpy(), PointSetConfig(k=pc["k"], gauss_c=pc["gauss_c"],
                                                gauss_eps=pc["gauss_eps"]),
        device=dev)
    del coords
    ctx.mark("tables built")
    state = classifier_state(ctx, rgba)
    c = cfg["classifier"]
    model = InceptionV3(c["num_classes"], aux_logits=c["aux_logits"]).to(dev)
    model.load_state_dict(state)
    logits_fn = make_classifier_logits_fn(model)
    ori = rgba.cpu().numpy()
    delta0 = delta0_of(cfg, rgba)
    del rgba
    n = ori.shape[0]
    acfg = attack_config(cfg)
    n_batches = -(-n // acfg.batch_size)
    picks = checked_steps(ctx, n_batches)
    rec = Recorder([n_batches + p for p in picks])
    labels = np.full(n, cfg["attack"]["label"], np.int64)
    ctx.mark("classifier loaded")
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
    ctx.keep.update(records=rec.records, weights=weights, idx=idx, ori=ori,
                    delta0=delta0, classifier=state, labels=labels)


def reference_model(ctx: Context, state: dict) -> RefInception:
    c = ctx.cfg["classifier"]
    model = RefInception(c["num_classes"], c["aux_logits"]).to(ctx.device)
    model.load_state_dict(state)
    return model.eval().requires_grad_(False)


def step_miss(prog_out: torch.Tensor, ref_out: torch.Tensor,
              before: torch.Tensor) -> float:
    """Percentage of the RGB entries that either side moved on which the
    program's step and the reference's disagree."""
    p, r, b = prog_out[..., :3], ref_out[..., :3], before[..., :3]
    moved = (p != b) | (r != b)
    n = int(moved.sum())
    return 100.0 * int(((p != r) & moved).sum()) / max(n, 1)


def recorded_views(ctx: Context, st: dict) -> List[int]:
    """The views of the recorded steps' batches, in order."""
    bs, n = ctx.cfg["attack"]["batch_size"], st["ori"].shape[0]
    starts = {(call % ctx.stats["n_batches"]) * bs
              for call, _, _ in st["records"]}
    return sorted(v for s in starts for v in range(s, min(s + bs, n)))


class Tables:
    """8-NN tables of some views, worked out again from the inputs by the
    reference: for every foreground pixel the exact neighbours nearer than
    the search's last cell size (0.3, beyond which a Gaussian weight of
    c 0.02 is 0 in float32), the rest of each row at distance inf and
    weight 0. A background pixel composites to white whatever the splat,
    so it takes no part in a step: weight 0 there."""

    def __init__(self, ctx: Context, views: List[int],
                 dist_fn=ref.exact_dist):
        _, _, rgba, coords, S = make_inputs(ctx)
        pc, dev = ctx.cfg["pointset"], ctx.device
        self.views = list(views)
        v = torch.tensor(self.views, device=dev)
        self.fg = rgba[v][..., 3] > 0
        self.queries = coords[v][self.fg]
        self.points = S
        del rgba, coords
        self.dist, idx = ref.grid_knn(self.queries, S, pc["k"],
                                      dist_fn=dist_fn)
        shape = (*self.fg.shape, pc["k"])
        self.weights = torch.zeros(shape, device=dev)
        self.idx = torch.zeros(shape, dtype=torch.int64, device=dev)
        self.weights[self.fg] = ref.gauss_weights(self.dist, pc["gauss_c"],
                                                  pc["gauss_eps"])
        self.idx[self.fg] = idx

    def rows(self, views: List[int]) -> List[int]:
        return [self.views.index(v) for v in views]


def reference_step(ctx: Context, st: dict, model, call: int,
                   before: torch.Tensor, tables: Tables) -> torch.Tensor:
    """The reference's step over the recorded call's batch, from the
    program's perturbation before it and the reference's own tables."""
    bs = ctx.cfg["attack"]["batch_size"]
    s = (call % ctx.stats["n_batches"]) * bs
    dev = ctx.device
    ids = slice(s, s + bs)
    rows = tables.rows(list(range(s, min(s + bs, st["ori"].shape[0]))))
    a = ctx.cfg["attack"]
    return ref.nerfail_s_step(
        before, torch.from_numpy(st["delta0"]).to(dev),
        tables.weights[rows], tables.idx[rows],
        torch.from_numpy(st["ori"][ids]).to(dev),
        torch.from_numpy(st["labels"][ids]).to(dev), model, a["eps"], a["a"],
        ctx.cfg["classifier"]["input_size"])


def table_gaps(tables: Tables, weights: torch.Tensor,
               idx: torch.Tensor) -> List[float]:
    """(knn_dist_gap, knn_weight_gap) of the tables (weights, idx) [V, H,
    W, k] of `tables.views` against the reference's, over every foreground
    pixel. The distance gap is the largest relative excess of the j-th
    nearest of the tables' neighbours (their distances worked out again
    exactly) over the exact j-th nearest, where that is nearer than the
    search's reach: rounding apart 0 for an exact search whatever order it
    gives tied points."""
    w = weights.to(tables.weights.device)[tables.fg]
    i = idx.to(tables.idx.device).long()[tables.fg]
    q, dist = tables.queries, tables.dist
    p_dist = torch.sort(torch.linalg.vector_norm(
        tables.points[i] - q[:, None, :], dim=-1), 1)[0]
    near = torch.isfinite(dist)
    # over the distance, floored at 1e-4 (a thirtieth of the surface's
    # pixel spacing) where a pixel's own point is its nearest
    excess = (p_dist - dist)[near] / dist[near].clamp(min=1e-4)
    dgap = float(excess.max()) if excess.numel() else 0.0
    wgap = float((torch.sort(w, 1, descending=True)[0]
                  - torch.sort(tables.weights[tables.fg], 1,
                               descending=True)[0]).abs().max())
    return [dgap, wgap]


def check(ctx: Context) -> List[Check]:
    st = ctx.keep
    model = reference_model(ctx, st["classifier"])
    tables = Tables(ctx, recorded_views(ctx, st))
    miss = 0.0
    for call, before, after in st["records"]:
        ref_out = reference_step(ctx, st, model, call, before, tables)
        miss = max(miss, step_miss(after, ref_out, before))
    if len(st["records"]) != ctx.traffic["checked_steps"]:
        miss = float("inf")
    v = tables.views
    vals = [miss] + table_gaps(tables, torch.from_numpy(st["weights"][v]),
                               torch.from_numpy(st["idx"][v]))
    st.clear()
    return [Check(n, v, ctx.limit(n))
            for n, v in zip(CHECKS, vals)]
