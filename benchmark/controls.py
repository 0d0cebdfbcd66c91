"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's on many seeds, the control's (the plain
reference in the program's place, its products in float8 e4m3, one
precision below the configuration's bfloat16) and each planted fault's
on a few.

    python3 benchmark/controls.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--out <file.json>]

Prints one line per reading and, with --out, writes them all as JSON.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import faults, harness  # noqa: E402
import contextlib  # noqa: E402

from benchmark.drivers import nerf_render, nerf_train, nerfail_s  # noqa: E402
from benchmark.reference import attack as ref_attack  # noqa: E402
from benchmark.reference import nerf as ref  # noqa: E402

BASE_SEED = 3_000_000_000


def train_readings(ctx, kind: str):
    if kind == "program":
        prog = nerf_train.first_steps(ctx)
    elif kind == "control":
        prog = nerf_train.reference_readings(ctx, mm=ref.fp8_mm)
    elif kind == "half_batch":
        prog = nerf_train.first_steps(ctx, sampler_wrap=faults.half_batch)
    elif kind == "state_unchanged":
        with faults.state_unchanged():
            prog = nerf_train.first_steps(ctx)
    else:
        raise ValueError(kind)
    refr = nerf_train.reference_readings(ctx)
    gaps = nerf_train.compare(prog, refr)
    out = dict(zip(("loss_gap", "grad_gap", "change_gap"), gaps))
    if prog["grads"] is not None:
        # where the worst gradient gap lies, and the median leaf's gap
        names = [f"{net}.{k}" for net in ("coarse", "fine")
                 for k, _, _ in [(n + s, 0, 0) for n, _, _ in
                                 ref.layer_names(ctx.cfg["model"])
                                 for s in ("_w", "_b")]]
        pn = [float(g.norm()) for g in prog["grads"]]
        rn = [float(g.norm()) for g in refr["grads"]]
        med = sorted(rn)[len(rn) // 2]
        leaf = [abs(a - b) / max(b, med) for a, b in zip(pn, rn)]
        worst = max(range(len(leaf)), key=leaf.__getitem__)
        out["info_worst_grad_leaf"] = names[worst]
        out["info_median_leaf_grad_gap"] = sorted(leaf)[len(leaf) // 2]
        out["info_losses"] = prog["losses"]
    return out


def render_readings(ctx, kind: str):
    if kind == "control":
        nerf_render.measure(ctx)
        done = ctx.keep.pop("done")
        rig, nets = nerf_render._inputs(ctx)
        # the fp8 reference's maps in the program's place, at the same rays
        p_rgb, p_pts, r_rgb, r_pts = [], [], [], []
        for c, px in nerf_render.sample(ctx, len(done)):
            view = done[c][0]
            a, b = nerf_render.reference_maps(ctx, rig, nets, view, px,
                                              ref.fp8_mm)
            x, y = nerf_render.reference_maps(ctx, rig, nets, view, px)
            p_rgb.append(a), p_pts.append(b), r_rgb.append(x), r_pts.append(y)
        vals = nerf_render.gaps(torch.cat(p_rgb), torch.cat(p_pts),
                                torch.cat(r_rgb), torch.cat(r_pts))
        return dict(zip(nerf_render.CHECKS, vals))
    if kind == "program":
        nerf_render.measure(ctx)
    else:
        with faults.render_fault(kind):
            nerf_render.measure(ctx)
    return {c.name: c.value for c in nerf_render.check(ctx)}


@contextlib.contextmanager
def tf32():
    """Matmuls and cuDNN convolutions in TF32: one precision below the
    configuration's float32 with TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def nerfail_s_readings(ctx, with_control: bool):
    """The program's readings of one short run (one window epoch) and,
    with_control, the TF32 reference's in the program's place: tables of
    the recorded steps' views found through TF32 products, and the same
    steps taken in TF32 from the program's perturbation over them."""
    nerfail_s.measure(ctx)
    st = dict(ctx.keep)
    out = {"program": {c.name: c.value for c in nerfail_s.check(ctx)}}
    if with_control:
        model = nerfail_s.reference_model(ctx, st["classifier"])
        views = nerfail_s.recorded_views(ctx, st)
        t32 = nerfail_s.Tables(ctx, views)
        with tf32():
            ttf = nerfail_s.Tables(ctx, views, ref_attack.product_dist)
        miss = 0.0
        for call, before, _ in st["records"]:
            r32 = nerfail_s.reference_step(ctx, st, model, call, before, t32)
            with tf32():
                rtf = nerfail_s.reference_step(ctx, st, model, call, before,
                                               ttf)
            miss = max(miss, nerfail_s.step_miss(rtf, r32, before))
        tab = nerfail_s.table_gaps(t32, ttf.weights, ttf.idx)
        out["control"] = dict(zip(nerfail_s.CHECKS, [miss] + tab))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--offset", type=int, default=0,
                    help="first seed index, so that calls use fresh seeds")
    ap.add_argument("--out")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else (
        torch.device("cpu"))
    cell = harness.load_cell(args.workload)
    engine = cell.workload["engine"]
    if engine == "nerfail_s":
        return attack_main(args, cell, dev)
    kinds = {"nerf_train": ("control", "half_batch", "state_unchanged"),
             "nerf_render": ("control", "altered", "half")}[engine]
    o = args.offset
    plan = [("program", BASE_SEED + o + s) for s in range(args.seeds)]
    plan += [(k, BASE_SEED + 1000 + o + s) for k in kinds
             for s in range(args.control_seeds)]
    out = []
    for kind, seed in plan:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, args.seconds, dev)
        if engine == "nerf_train":
            vals = train_readings(ctx, kind)
        else:
            vals = render_readings(ctx, kind)
        rec = {"cell": args.workload, "kind": kind, "seed": seed, **vals,
               "s": time.perf_counter() - t0}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    for kind in ["program", *kinds]:
        rows = [r for r in out if r["kind"] == kind]
        names = [k for k in rows[0] if k not in ("cell", "kind", "seed", "s")
                 and not k.startswith("info_")]
        print(kind, {n: (min(r[n] for r in rows), max(r[n] for r in rows))
                     for n in names}, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def attack_main(args, cell, dev) -> int:
    """The attack cells: each seed's run gives the program's readings; the
    first --control-seeds of them also the control's."""
    out = []
    for s in range(args.seeds):
        seed = BASE_SEED + args.offset + s
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, 0.0, dev)
        got = nerfail_s_readings(ctx, s < args.control_seeds)
        for kind, vals in got.items():
            rec = {"cell": args.workload, "kind": kind, "seed": seed, **vals,
                   "views_per_s": ctx.e2e.get("nerfail_s_views_per_s"),
                   "s": time.perf_counter() - t0}
            out.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
