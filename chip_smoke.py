#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerfail_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of the repository. It needs one CUDA device and nvcc,
and exits non-zero without a result line when either is missing.

1. builds the CUDA kernels from nerfail_tpu_torch/csrc (one nvcc each, in
   parallel);
2. trains Inception-V3 (auxiliary head on) on the 8 box classes rendered
   at 800² and resized to 299² by the attack's own resize, 24 train and
   4 validation views a class, Adam 3e-4, batch 16, 40 epochs, keeping
   the best validation epoch (eval/asr_800.py): the attack's target;
3. drives the port's two attack paths at full width, through their
   entry points, each with every kernel launch counter set to 0 just
   before and read just after: 16 views of the box scene (class 0) at
   800², a point set of 3·800² = 1.92 M points from 3 mask views, the
   8-NN tables by K3 (build_index_and_dist: the plan on the card, the
   split search and the merge; the time of each part per view) and their
   Gaussian weights, against the trained Inception-V3 at 299², whose
   clean accuracy on the 16 views must be ≥ 0.8:
   a. NeRFail-S (ε = 32, a = 2, batch 8, 2 epochs: 4 steps, each through
      K1), and evaluate_attack on the result;
   b. NeRFail on the same tables with the reference's m1 = 8 (ε = 32,
      m2 = 1000, view batch 8, DeepFool ≤ 50 iterations, 3 epochs, as
      the TPU's 800² run): every DeepFool iteration runs one K2 launch
      for the 8 class norms and one K1 launch for the chosen class; at
      least one view must flip; evaluate_attack on the result;
   then evaluate_testset on each engine's attacked views, whose ASR must
   be evaluate_attack's; and checks what came out: shapes, finite
   values, the ε-ball, exact self-distances, K1/K2 launch counts against
   the engine evaluations that the history's per-view DeepFool
   iterations imply, and 32² runs of both engines whose CUDA path must
   agree with the port's CPU path (the plain versions, held against JAX
   by the tests);
4. trains SimpleCNN with the port's trainer on the 64² box classes and
   attacks it with both engines (tests/test_asr.py's fixture);
5. holds each kernel against its plain PyTorch version on the card at
   the paths' shapes (K1 both as NeRFail-S's backward and as the
   DeepFool pick, which reads each view's class out of the class stack in
   place), times kernel, plain version and library call, and computes
   each kernel's bound from this run's inputs; times K1/K2 on plans that
   list only touched rows against plans that list every row, in the
   plans' plan-row order against the Morton order of each row's first
   pixel (K1 bit-equal in both), and the in-place pick against a copy of
   the class followed by K1;
   times K3's plan, search and merge on a whole view, and holds the split
   search against one work item a row;
6. walks DeepFool on batch 0 (time per iteration; the summed step must
   be finite, nonzero and keep alpha), splits one engine iteration by
   CUDA events (the pick in place and as a class copy + K1), and
   profiles one steady NeRFail-S step and one DeepFool iteration (device
   busy share, top kernels);
7. the NeRF path at full width, with the K4/K5 counters set to 0 before
   each part and read after: train_nerf for 30 steps on the 800² box
   scene (8×256 MLP, 1024 rays of 64 + 128 samples; K4 and K5 twice per
   step), then extract_coord_maps for one 800² view (K4 twice per chunk
   of 32 768 rays): step time, render time, peak memory;
8. holds K4 and K5 against their plain versions at a train step's shapes
   (262 144 points), bit-equal across launches, with times (K5's two
   kernels also apart), K5's device memory, the bf16 cuBLAS yardstick and
   the bounds; trains the 64² NeRF of the verify
   recipe through K4/K5 (test PSNR, pts_max against the analytic surface,
   tables by K3 from its coordinate maps); runs a 16² train_nerf on CUDA
   and on the CPU with the same rays and uniforms (loss histories must
   agree); profiles one steady full-width train step; and prints K4's
   utils/profiling.roofline at 262 144 points;
8b. make_multi_train_step at full width (k = 10 steps captured as one
   CUDA graph over K4/K5, precrop off): the captured window bit-equal to
   10 eager make_train_step steps of the same capturable Adam on the same
   (seed, i) draws, then 5 replayed windows: eager (plain Adam, as
   train_nerf steps) and replayed step times (CUDA events and host wall),
   the idle share of one replay from utils/profiling.device_trace, peak
   memory; K4/K5 counted through their wrappers (warm-up step and
   capture, 2 + 2k; none in the replays) and as the kernels the profiled
   replay launched (2k each);
9. runs every classifier of the registry at its input size on the card,
   seeded torch init in eval mode: the forward and the input gradient of
   the cross-entropy at batch 8 (finite; times by CUDA events, peak
   memory), and the CUDA logits against the CPU's on one image; then
   imports the reference's InceptionResNetV2 tensors (regenerated from
   tests/golden/reference_goldens.npz as the JAX tests do) through
   models/classifiers/torch_import and holds its logits on the card to
   the reference's at 2e-3, and writes 4 annotated 800² views through
   evaluate_testset(annotate_dir=...) (file names, text box, colour);
10. the four engines as a user runs them, through
   `Pipeline.stage_attack` on the main path's 16 views, tables and
   trained Inception-V3 (ε 32, a 2, batch and view batch 8, m2 1000,
   DeepFool ≤ 50 iterations; NeRFail-S, IGSM-2D and UAP-2D for 1 epoch,
   NeRFail for 2, its one DeepFool epoch and the reference's final
   evaluation epoch), each with save and checkpoint on and then
   `stage_eval`: wall and epoch time, ASR, clean accuracy, e_max ≤ ε,
   peak memory; K1 launched by both 3D engines and K2 by NeRFail, no
   kernel by the 2D engines; r_0.png read back by utils/png equal to the
   clipped view; attack_state.npz gone; the PNG codec's write and read
   time for one 800² RGBA image;
11. the CLI in process (`nerfail_tpu_torch.cli.main`) on a box scene
   written by `write_blender_format` at 200² (cut from the reference's
   --half_res 400² for time: CLI_H), 8 + 2 + 128 views (so the
   reference's mask views 50, 75, 125 exist), the full-width NeRF from a
   config file: train-nerf (300 steps), extract-coords, render-only,
   invert-disturbance, train-classifier (SimpleCNN, 2 epochs on an
   8-class root at 64²), attack (NeRFail-S, 1 epoch, against the
   Inception-V3 above), evaluate and inherit (100 retrain steps, renders
   at render_factor 2): each command's wall time and K1-K5 launches, and
   every artifact the reference's grammar names;
12. [multi], the sharded paths (parallel/) in several ranks, one process
   each (parallel/launch.spawn), given the main path's tables, views, δ0
   and Inception-V3 and phase 7's scene through files in a temporary
   directory:
   a. 2 gloo ranks sharing cuda:0 on a (2, 1) mesh run phase 3a's
      NeRFail-S and phase 3b's NeRFail: the histories (attack accuracy;
      m1, m2, DeepFool calls) equal to the single-process runs', δ
      bit-equal across the ranks and within 1 % of the single run's
      entries, the same final ASR, K1 once per batch on every rank and K2
      and the pick once per DeepFool iteration of the rank's views;
   b. the same ranks run phase 7's train_nerf on a (2, 1) and a (1, 2)
      mesh: losses within 0.1 % of phase 7's at every step, the final
      parameters within 1e-4 of its on ≥ 99.9 % of entries, K4 and K5
      twice per step per rank, and a captured window over gloo raises;
   c. an NCCL world of one rank per visible card (1 on a one-card
      machine) runs phase 3a's NeRFail-S (history and ASR as in a) and one
      make_multi_train_step window of 10 steps, its all-reduce captured
      in the graph, bit-equal to 10 eager sharded steps.
   The times of a and b are of ranks sharing one card, not a scaling
   result.

Its last lines are one JSON object {"kernels": [...]}, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

SEED = 0
H = 800
N_VIEWS = 16
MASK_VIEWS = (0, 1, 2)
GAUSS_C = 0.02                 # reference c at 800² (GaussNet.py:79)
RESIZE = 299
N_CLASSES = 8
EPS, STEP_A, BATCH, EPOCHS = 32.0, 2.0, 8, 2
# NeRFail as the TPU's 800² run (tools/asr_demo_report.json): the
# reference's m1 = 8 (AttackConfig's default), m2 = 1000, DeepFool cap 50;
# 3 epochs
DF_M2, DF_MAX_ITER, DF_EPOCHS = 1000.0, 50, 3
CLS_EPOCHS = 40                # Inception training (tools/full_rehearsal.py)
CLEAN_ACC_BAR = 0.8            # tools/asr_demo.py:44
ZOO_BATCH = 8

# NeRF path (tools/profile_train.py's setup): scene, steps, render
NERF_H = 800
NERF_STEPS = 30
NERF_RENDER_LIMIT_S = 120.0    # above this estimate the view renders at 400²
QUALITY_STEPS = 1500
K45_POINTS = 1024 * (64 + 192)  # a full-width train step: 64 coarse + 192 fine per ray

# Pipeline and CLI phases: the four engines through Pipeline.stage_attack
# on the main path's tables (NeRFail runs one DeepFool epoch and the
# reference's final evaluation epoch, since its only epoch would be the
# final one), and the CLI on a written box scene of 8 + 2 + 128 views, so
# that the mask views (50, 75, 125) exist. The CLI scene is cut from the
# reference's --half_res 400² to 200²: at 400² the CLI phase took 218.6 s
# on the H100 (700 W), over the two phases' 150 s budget, and its 128
# test views cannot be cut
PIPE_EPOCHS = {"NeRFail_S": 1, "NeRFail": 2, "IGSM_2D": 1, "Universal_2D": 1}
CLI_H = 200
CLI_VIEWS = (8, 2, 128)
CLI_NERF_STEPS = 300
CLI_INHERIT_STEPS = 100
CLI_CLASS_H = 64               # the 8-class root of train-classifier
CLI_CLS_EPOCHS = 2

try:
    from nerfail_tpu_torch.utils.profiling import H100_SXM
except ImportError as e:        # chip_smoke.py away from the repository
    sys.exit(f"chip_smoke: run from the repository root ({e})")

# H100 SXM peaks (NVIDIA data sheet, utils/profiling.py): HBM3 bytes/s,
# fp32 (non-tensor) and dense bf16 tensor-core flop/s
PEAK_BYTES = H100_SXM.bytes_per_s
PEAK_FP32 = H100_SXM.fp32
PEAK_BF16 = H100_SXM.bf16
# fp32 operations that are not FMAs (K3's rounded sub, mul and add): one
# per lane per cycle, 132 SMs × 128 lanes × 1.98 GHz, half of PEAK_FP32,
# which counts an FMA as two
PEAK_FP32_NON_FMA = PEAK_FP32 / 2


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scene(n_views: int, size: int):
    """Poses and intrinsics as tools/full_rehearsal.py `_scene`."""
    from nerfail_tpu_torch.eval.asr_800 import attack_scene

    return attack_scene(n_views, size, seed=SEED)


def views(K, poses, size: int):
    """uint8 RGBA renders [N, size, size, 4] and the point set S."""
    from nerfail_tpu_torch.eval.asr_800 import attack_views

    return attack_views(K, poses, size, MASK_VIEWS)


def tables(K, poses, S, size, dev, prep=None, split=None):
    """Every view's 8-NN table and weights through build_index_and_dist.
    With a `split` dict, appends each view's wall seconds of each part:
    "coord_map" (this script's host geometry), "plan" and "search" (K3's
    plan on the card; work items, search, merge and un-permutation, each
    ending in a sync) and "weights"."""
    import torch

    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
    from nerfail_tpu_torch.pointset.weights import gauss_weights

    ws, ids, d0 = [], [], None
    for v in range(len(poses)):
        t0 = time.perf_counter()
        cm = analytic_coord_map(poses[v], size, size, K)
        t1 = time.perf_counter()
        part = None if split is None else {"coord_map": t1 - t0}
        d, i = build_index_and_dist(cm, S, method="device", device=dev,
                                    prep=prep, timings=part)
        t2 = time.perf_counter()
        ws.append(gauss_weights(d, c=GAUSS_C * 800.0 / size))
        ids.append(i)
        if split is not None:
            torch.cuda.synchronize(dev)
            part["weights"] = time.perf_counter() - t2
            for name, sec in part.items():
                split.setdefault(name, []).append(sec)
        if v == 0:
            d0 = d
    return torch.stack(ws), torch.stack(ids), d0


def white_resized(rgba, dev):
    """White-composited RGB at the classifier's size, [N, 299, 299, 3]."""
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        resize_batch, white_composite_255,
    )

    x = torch.as_tensor(rgba, device=dev).to(torch.float32)
    return resize_batch(white_composite_255(x[..., :3], x[..., 3:4]), RESIZE)


def every_row(plan):
    """The same pairs with every output row listed, empty rows included:
    the layout without touched-row compaction, to time the choice. Each
    view's touched rows keep their launch order, and its empty rows
    follow them."""
    import dataclasses

    import torch

    from nerfail_tpu_torch.ops.cuda.segsum_kernel import launch_rows_of

    dev, N, V = plan.device, plan.num_points, plan.n_views
    counts = torch.zeros(N, dtype=torch.int32, device=dev)
    counts[plan.rows.long()] = torch.diff(plan.row_ptr)
    row_ptr = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    key = torch.arange(N, dtype=torch.int64, device=dev) + plan.n_rows
    key[plan.launch_rows[:, 2].long()] = torch.arange(plan.n_rows,
                                                      device=dev)
    key += torch.arange(N, device=dev) // (N // V) * (N + plan.n_rows)
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    view_ptr = torch.arange(V + 1, dtype=torch.int32, device=dev) * (N // V)
    lr = launch_rows_of(row_ptr, rows, view_ptr)[torch.argsort(key)]
    return dataclasses.replace(
        plan, row_ptr=row_ptr, rows=rows, view_ptr=view_ptr,
        launch_rows=lr.contiguous(), view_rows=(N // V,) * V)


def morton(plan):
    """The same plan walked in the Morton order of each row's first pixel
    (each view read as H × H pixels): the launch order measured against
    the plans' plan-row order (tools/segsum_order.py)."""
    from tools.segsum_order import morton_order, reordered

    return reordered(plan, morton_order(plan, H))


def inception_phase(dev):
    """The attack's target: Inception-V3 trained on the 800² box classes
    through the attack's resize (eval/asr_800.py), in deterministic cuDNN
    algorithms so that a card and software train the same network."""
    import torch

    from nerfail_tpu_torch.eval import asr_800

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.time()
    data = asr_800.class_data(device=dev)
    data_s = time.time() - t0
    log(f"[inception] {len(data['tr_y'])} train and {len(data['va_y'])} "
        f"validation views, rendered at {H}² and resized to {RESIZE}² on "
        f"the card: {data_s:.3f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    model, info = asr_800.train_inception(
        data, device=dev, epochs=CLS_EPOCHS,
        log_fn=lambda e, m: log(f"[inception] epoch {e}: {json.dumps(m)}"))
    torch.backends.cudnn.deterministic = False
    info.update(data_s=data_s,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    log(f"[inception] trained (Adam 3e-4, batch 16, {CLS_EPOCHS} epochs, "
        f"aux head × 0.4) in {info['train_s']:.3f} s, peak "
        f"{info['peak_gb']:.3f} GiB; best val_acc {info['val_acc']:.4f} at "
        f"epoch {info['best_epoch']}, kept")
    return model, info


def main_path(dev, K, poses, ori, S, model):
    """Tables → NeRFail-S → evaluate_attack, through the entry points,
    against the trained `model`."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        make_classifier_logits_fn, zero_init_mask,
    )
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.eval.harness import predict_all
    from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep

    out = {}
    torch.cuda.synchronize()
    t0 = time.time()
    prep = KnnPrep(S, device=dev)
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    split = {}
    weights, idx, d_view0 = tables(K, poses, S, H, dev, prep=prep,
                                   split=split)
    torch.cuda.synchronize()
    out["tables_s"] = time.time() - t0
    out["table_split_ms"] = {
        k: {"mean": float(np.mean(v)) * 1e3, "median": float(np.median(v))
            * 1e3} for k, v in split.items()}
    log(f"[tables] {N_VIEWS} views × {H}², M = {S.shape[0]}: "
        f"{out['tables_s']:.3f} s (point prep on the card {prep_s:.3f} s); "
        f"per view, wall time ending in a sync, mean / median of "
        f"{N_VIEWS}: " + ", ".join(
            f"{k} {v['mean']:.3f} / {v['median']:.3f} ms"
            for k, v in out["table_split_ms"].items()))

    logits_fn = make_classifier_logits_fn(model)
    ori_d = torch.from_numpy(ori).to(dev)
    with torch.no_grad():
        clean = torch.cat([white_resized(ori_d[s:s + BATCH], dev).cpu()
                           for s in range(0, N_VIEWS, BATCH)]).numpy()
    out["clean_acc"] = float(np.mean(predict_all(
        logits_fn, clean, BATCH, device=dev) == 0))
    log(f"[attack] trained Inception-V3 on the {N_VIEWS} attacked views "
        f"(class 0): clean accuracy {out['clean_acc']:.4f}")
    require(out["clean_acc"] >= CLEAN_ACC_BAR,
            f"clean accuracy on the attacked views ≥ {CLEAN_ACC_BAR}")
    delta0 = zero_init_mask(ori[list(MASK_VIEWS)].astype(np.float32)).numpy()
    labels = np.zeros(N_VIEWS, np.int64)
    cfg = AttackConfig(method="NeRFail_S", eps=EPS, a=STEP_A,
                       batch_size=BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    res = nerfail_s_attack(
        delta0, weights, idx, ori_d, labels, logits_fn, cfg,
        resize_to=RESIZE, epochs=EPOCHS, device=dev,
        log_fn=lambda e, m: log(f"[attack] epoch {e}: {json.dumps(m)}"),
    )
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_batches = -(-N_VIEWS // BATCH)
    # epoch 0 also builds and uploads each batch's tables and CSR plan
    out["step_ms"] = res.history[-1]["time_s"] / n_batches * 1e3
    out["first_epoch_s"] = res.history[0]["time_s"]
    log(f"[attack] steady step time {out['step_ms']:.3f} ms "
        f"(epoch {EPOCHS - 1} wall time / {n_batches} steps); epoch 0 with "
        f"plan builds {out['first_epoch_s']:.3f} s; peak device memory "
        f"{out['peak_gb']:.3f} GiB")

    out.update(weights=weights, idx=idx, ori_d=ori_d, clean=clean,
               logits_fn=logits_fn)
    attacked, report = attack_report(dev, out, res.delta, "NeRFail-S")
    out.update(res=res, report=report, d_view0=d_view0, delta0=delta0,
               prep=prep, attacked=attacked)
    return out


def attack_report(dev, mp, delta, name):
    """The attacked views under δ, white-composited at 299², and
    evaluate_attack's report on them against the clean views; then
    evaluate_testset on the same views, whose ASR must be the same."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import splat_attack_forward
    from nerfail_tpu_torch.eval.harness import (
        evaluate_attack, evaluate_testset,
    )

    attacked = []
    with torch.no_grad():
        for s in range(0, N_VIEWS, BATCH):
            sl = slice(s, s + BATCH)
            o = splat_attack_forward(
                torch.as_tensor(delta, device=dev).reshape(-1, 4),
                mp["weights"][sl], mp["idx"][sl], mp["ori_d"][sl],
                mp["logits_fn"], eps=EPS, resize_to=RESIZE, device=dev)
            attacked.append(white_resized(o["attacked_rgba"], dev).cpu())
    attacked = torch.cat(attacked).numpy()
    report = evaluate_attack(mp["logits_fn"], attacked, mp["clean"],
                             true_label=0, num_classes=N_CLASSES,
                             batch_size=BATCH, device=dev)
    log(f"[eval] {name}, trained Inception-V3, {N_VIEWS} views at {H}²: "
        f"ASR {report['asr']:.4f}, clean accuracy "
        f"{report['clean_acc_target_class']:.4f}, e_max "
        f"{report['e_max']:.4f} ≤ ε = {EPS}, PSNR mean "
        f"{report['psnr_avg']:.4f} dB (at {RESIZE}²); evaluate_attack: "
        f"{json.dumps(report)}")
    require(report["e_max"] <= EPS + 1e-3, f"{name}: e_max ≤ ε")
    ts = evaluate_testset(mp["logits_fn"], attacked,
                          np.zeros(N_VIEWS, np.int64), attacked_class=0,
                          original_images=mp["clean"],
                          num_classes=N_CLASSES, batch_size=BATCH,
                          device=dev)
    log(f"[eval] {name}, evaluate_testset: {json.dumps(ts)}")
    require(ts["asr"] == report["asr"],
            f"{name}: evaluate_testset's ASR is evaluate_attack's")
    return attacked, report


def check_outputs(mp, S):
    import numpy as np
    import torch

    res, delta0 = mp["res"], mp["delta0"]
    d = res.delta
    require(d.shape == (len(MASK_VIEWS), H, H, 4), f"δ shape {d.shape}")
    require(np.isfinite(d).all(), "δ finite")
    np.testing.assert_array_equal(d[..., 3], delta0[..., 3])
    rgb = d[..., :3]
    require(np.abs(rgb).max() <= EPS, "δ inside the ε-ball")
    require((rgb[delta0[..., 3] == 0] == 0).all(), "δ zero outside alpha")
    require(np.all(np.mod(rgb, STEP_A) == 0), "δ a multiple of the step")
    require(np.abs(rgb).max() > 0, "δ moved")
    w, i = mp["weights"], mp["idx"]
    require(tuple(w.shape) == (N_VIEWS, H, H, 8), "weights shape")
    require(bool(torch.isfinite(w).all()), "weights finite")
    require(int(i.min()) >= 0 and int(i.max()) < S.shape[0], "idx range")
    require(bool((w.sum(-1) < 1).all()), "weight sums < 1")
    # view 0 is a mask view: every pixel's own surface point is in S
    require(bool((mp["d_view0"][..., 0] == 0).all()), "self-distance 0")
    rep = mp["report"]
    require(all(np.isfinite(v) for v in rep.values()
                if isinstance(v, float) and v != float("inf")),
            "report finite")
    require(rep["e_max"] <= EPS + 1e-3, "attacked images inside ε")
    for h in res.history:
        require(0 <= h["attack_acc"] <= 1 and 0 <= h["clean_acc"] <= 1,
                "history accuracies")
    log("[check] main-path outputs: shapes, finite values, ε-ball, "
        "step grid, self-distances: ok")


def small_cuda_vs_cpu(dev):
    """At 32²: the CUDA path (K3, K1) against the port's CPU path."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        make_classifier_logits_fn, zero_init_mask,
    )
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.models.classifiers.simple_cnn import SimpleCNN

    size, n = 32, 6
    K, poses = scene(n, size)
    ori, S = views(K, poses, size)
    got = {}
    for d in (dev, torch.device("cpu")):
        w, i, _ = tables(K, poses, S, size, d)
        got[d.type] = (w.cpu().numpy(), i.cpu().numpy())
    wd, id_ = got["cuda"]
    wc, ic = got["cpu"]
    np.testing.assert_allclose(wd, wc, rtol=1e-5, atol=1e-7)
    require(np.mean(id_ == ic) > 0.9, "small tables: indices agree")
    torch.manual_seed(SEED)
    model = SimpleCNN(num_classes=N_CLASSES)
    delta0 = zero_init_mask(ori[list(MASK_VIEWS)].astype(np.float32)).numpy()
    cfg = AttackConfig(eps=EPS, a=STEP_A, batch_size=4)
    runs = {}
    for d in (dev, torch.device("cpu")):
        m = SimpleCNN(num_classes=N_CLASSES).to(d)
        m.load_state_dict(model.state_dict())
        runs[d.type] = nerfail_s_attack(
            delta0, wc, ic, ori, np.zeros(n), make_classifier_logits_fn(m),
            cfg, resize_to=None, epochs=2, device=d)
    agree = float(np.mean(runs["cuda"].delta == runs["cpu"].delta))
    require(agree >= 0.99, f"small run δ agreement {agree}")
    require([h["clean_acc"] for h in runs["cuda"].history]
            == [h["clean_acc"] for h in runs["cpu"].history],
            "small run clean_acc history")
    log(f"[check] 32² CUDA path vs CPU path: tables allclose, δ agrees on "
        f"{agree:.6f} of entries: ok")


def k1_phase(dev, mp, M):
    """K1 at the main path's shapes, on a real step's cotangent."""
    import torch
    import torch.nn.functional as F

    from nerfail_tpu_torch.attacks.forward import (
        composite_after_splat, resize_batch,
    )
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        build_csr_plan, error_bound, plan_point_ids, segment_sum,
        segment_sum_plain,
    )
    from nerfail_tpu_torch.ops.splat import splat_forward

    sl = slice(0, BATCH)
    w, idx = mp["weights"][sl], mp["idx"][sl]
    ori = mp["ori_d"][sl].to(torch.float32)
    mask = ori[..., 3:] > 0
    torch.cuda.synchronize()
    t0 = time.time()
    plan = build_csr_plan(idx, w, M, pair_mask=mask)
    torch.cuda.synchronize()
    plan_ms = (time.time() - t0) * 1e3
    log(f"[K1] CSR plan for {BATCH}×{H}² on the card: {plan_ms:.3f} ms, "
        f"{plan.n_pairs} kept pairs of {idx.numel()}, {plan.n_rows} touched "
        f"rows of {M}")

    delta = torch.from_numpy(mp["res"].delta).to(dev).reshape(-1, 4)
    splat = splat_forward(delta, idx, w).requires_grad_(True)
    out = composite_after_splat(splat, ori, eps=EPS)
    logits = mp["logits_fn"](resize_batch(out["cla_x"], RESIZE))
    labels = torch.zeros(BATCH, dtype=torch.int64, device=dev)
    (g,) = torch.autograd.grad(F.cross_entropy(logits, labels), splat)
    g = g.reshape(-1, 4).contiguous()

    k = segment_sum(g, plan)
    k2 = segment_sum(g, plan)
    ref = segment_sum_plain(g, plan)
    torch.cuda.synchronize()
    require(torch.equal(k, k2), "K1 bit-equal across runs")
    err = (k - ref).abs()
    bound = error_bound(g, plan)
    require(bool((err <= bound).all()), "K1 within the fp32 sum bound")
    require(float(ref.abs().max()) > 0, "K1 cotangent is not all zero")
    max_err = float(err.max())

    ms = cuda_ms(lambda: segment_sum(g, plan), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: segment_sum_plain(g, plan), reps=5)
    pt = plan_point_ids(plan)
    contrib = plan.w[:, None] * g[plan.pix.long()]
    acc = torch.zeros(M, 4, device=dev)
    library_ms = cuda_ms(lambda: acc.index_add_(0, pt, contrib), reps=5)
    full = every_row(plan)
    require(torch.equal(segment_sum(g, full), k),
            "K1 on every row equals K1 on the touched rows")
    every_row_ms = cuda_ms(lambda: segment_sum(g, full), reps=20, warmup=2)
    zplan = morton(plan)
    require(torch.equal(segment_sum(g, zplan), k),
            "K1 bit-equal in plan-row and Morton launch order")
    morton_ms = cuda_ms(lambda: segment_sum(g, zplan), reps=20, warmup=2)
    P, R, C = plan.n_pairs, plan.n_rows, 4
    kept_pix = int(mask.sum())
    nbytes = 8 * P + 4 * C * kept_pix + 4 * (2 * R + 1) + 4 * C * M
    bound_ms = max(nbytes / PEAK_BYTES, 2 * P * C / PEAK_FP32) * 1e3
    log(f"[K1] max |kernel − plain| {max_err:.3e} (≤ per-entry fp32 bound "
        f"max {float(bound.max()):.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({nbytes} bytes)")
    log(f"[plan] NeRFail-S K1, touched rows vs every row: {ms:.4f} vs "
        f"{every_row_ms:.4f} ms; plan-row vs Morton launch order (bit-equal):"
        f" {ms:.4f} vs {morton_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / PEAK_BYTES
            >= 2 * P * C / PEAK_FP32 else "operations",
            "n_pairs": P, "n_rows": R, "plan_ms": plan_ms,
            "every_row_ms": every_row_ms, "morton_ms": morton_ms}


def k3_bound(plan):
    """(bound_ms, bound_by) of K3 on a plan: the larger of its bytes (the
    queries, the packed points, the CSR and the output, each once) over
    the memory rate and of its 8 non-FMA operations per pair of the
    plan's static pair count over their rate."""
    prep = plan.prep
    ops = 8 * plan.pair_count()
    nbytes = (4 * plan.qpk.numel() + 4 * prep.ppk.numel()
              + 4 * (plan.tiles.numel() + plan.row_ptr.numel())
              + plan.n_q * plan.tq * 8 * 8)
    t_ops, t_bytes = ops / PEAK_FP32_NON_FMA, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def item_pairs(plan, work):
    """Pairs each work item evaluates (its tiles' real points × tq)."""
    import torch

    real = torch.clamp(plan.prep.M - plan.tiles.long() * plan.prep.tp,
                       max=plan.prep.tp)
    cs = torch.zeros(real.numel() + 1, dtype=torch.int64, device=real.device)
    cs[1:] = torch.cumsum(real, 0)
    first, count = work.items[:, 1].long(), work.items[:, 2].long()
    return (cs[first + count] - cs[first]) * plan.tq


def k3_phase(dev, mp, K, poses, S):
    """K3 on 64 K queries of view 0 against all 1.92 M points (against the
    plain brute force), then on the whole view: the plan on the card, the
    work items, the search and the merge apart, and the split against the
    same kernels with one item a row (bit-equal, ties included)."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.ops.cuda.knn_kernel import (
        ITEM_TILES, K3Launch, KnnQueryPlan, knn, knn_plain, knn_sq_cuda,
    )

    prep = mp["prep"]
    M = S.shape[0]
    cm = analytic_coord_map(poses[0], H, H, K).reshape(-1, 3)
    mid = cm.shape[0] // 2
    q = cm[mid - 32768: mid + 32768]

    plan = KnnQueryPlan(q, prep)
    d, i = knn(plan=plan)
    qt, pt = torch.from_numpy(q).to(dev), torch.from_numpy(S).to(dev)
    d9, i9 = knn_plain(qt, pt, k=9, q_chunk=8192, p_tile=32768)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(d).all()), "K3 distances finite")
    max_err = float((d - d9[:, :8]).abs().max())
    require(torch.equal(d, d9[:, :8]),
            "K3 distances bit-equal to the plain version")
    untied = torch.ones(q.shape[0], 8, dtype=torch.bool, device=dev)
    untied[:, 1:] &= d9[:, 1:8] != d9[:, :7]
    untied &= d9[:, :8] != d9[:, 1:9]
    require(torch.equal(i.long()[untied], i9[:, :8][untied]),
            "K3 indices match wherever the distance is not tied")
    k3 = K3Launch.prepare(plan.qpk, prep.ppk, plan.tiles, plan.work(), M)
    ms = cuda_ms(lambda: (k3.search(), k3.merge()), reps=3)
    plain_ms = cuda_ms(lambda: knn_plain(qt, pt, k=8, q_chunk=8192,
                                         p_tile=32768), reps=1, warmup=0)
    bound_ms, bound_by = k3_bound(plan)
    log(f"[K3] {q.shape[0]} queries × {M} points: max |kernel − plain| "
        f"{max_err:.3e} (bit-equal), untied "
        f"{float(untied.float().mean()):.6f}; search + merge {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({plan.pair_count()} pairs, {bound_by})")

    # the whole view, its coordinate map already on the card
    cm_d = torch.from_numpy(cm).to(dev)
    KnnQueryPlan(cm_d, prep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        vplan = KnnQueryPlan(cm_d, prep)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) / 3 * 1e3
    work_ms = cuda_ms(vplan.work, reps=3)
    work = vplan.work()
    pairs = item_pairs(vplan, work)
    kv = K3Launch.prepare(vplan.qpk, prep.ppk, vplan.tiles, work, M)
    search_ms = cuda_ms(kv.search, reps=3)
    merge_ms = cuda_ms(kv.merge, reps=3)
    view_ms = cuda_ms(lambda: knn_sq_cuda(vplan.qpk, prep.ppk, vplan.tiles,
                                          work, M), reps=3)
    max_c = vplan.max_c()
    one = vplan.work(max_c)
    split_out = knn_sq_cuda(vplan.qpk, prep.ppk, vplan.tiles, work, M)
    one_out = knn_sq_cuda(vplan.qpk, prep.ppk, vplan.tiles, one, M)
    torch.cuda.synchronize()
    require(torch.equal(split_out[0], one_out[0])
            and torch.equal(split_out[1], one_out[1]),
            "K3 split search + merge bit-equal to one item a row")
    one_ms = cuda_ms(lambda: knn_sq_cuda(vplan.qpk, prep.ppk, vplan.tiles,
                                         one, M), reps=2)
    view_bound_ms, _ = k3_bound(vplan)
    rows = torch.diff(vplan.row_ptr).cpu().numpy()
    log(f"[K3] whole view ({cm.shape[0]} queries, {vplan.n_q} query tiles; "
        f"candidate tiles a row: median {int(np.median(rows))}, max {max_c}): "
        f"plan on the card {plan_ms:.3f} ms (host clock, syncs included), "
        f"work items {work_ms:.4f} ms; {work.items.shape[0]} items of ≤ "
        f"{ITEM_TILES} tiles, {work.merges.shape[0]} split rows, largest "
        f"item {int(pairs.max())} pairs; search {search_ms:.4f} ms, merge "
        f"{merge_ms:.4f} ms, search + merge {view_ms:.4f} ms against one item "
        f"a row {one_ms:.4f} ms (bit-equal); bound {view_bound_ms:.4f} ms "
        f"({vplan.pair_count()} pairs at {PEAK_FP32_NON_FMA:.3e} non-FMA "
        f"op/s)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "queries": q.shape[0], "view_ms": view_ms,
            "view_bound_ms": view_bound_ms, "view_search_ms": search_ms,
            "view_merge_ms": merge_ms, "view_plan_ms": plan_ms,
            "view_work_ms": work_ms, "view_one_item_a_row_ms": one_ms,
            "view_items": work.items.shape[0],
            "view_split_rows": work.merges.shape[0],
            "view_largest_item_pairs": int(pairs.max()),
            "view_pairs": vplan.pair_count(), "view_max_c": max_c,
            "item_tiles": ITEM_TILES}


def nerfail_path(dev, mp):
    """NeRFail on the main path's tables: batched DeepFool through the
    K1/K2 engine, with the reference control plane."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.config import AttackConfig

    cfg = AttackConfig(method="NeRFail", eps=EPS, m2=DF_M2,
                       df_max_iter=DF_MAX_ITER, view_batch=BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = nerfail_attack(
        mp["delta0"], mp["weights"], mp["idx"], mp["ori_d"],
        mp["logits_fn"], cfg, resize_to=RESIZE, epochs=DF_EPOCHS,
        device=dev,
        log_fn=lambda e, m: log(f"[nerfail] epoch {e}: {json.dumps(m)}"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # a batch's walk evaluates the engine once per iteration of its
    # slowest view, plus once to see every view flipped unless all froze
    loops = flipped = 0
    for h in res.history:
        iters = h["deepfool_iters"]
        require(all(len(b) == BATCH for b in iters)
                and h["deepfool_calls"] <= BATCH * len(iters)
                and (h["deepfool_calls"] == 0) == (not iters),
                f"DeepFool batches of epoch {h['epoch']}")
        loops += sum(max(min(i + 1, DF_MAX_ITER) for i in b) for b in iters)
        flipped += sum(i < DF_MAX_ITER for b in iters for i in b)
    log(f"[nerfail] {len(res.history)} epochs, {loops} DeepFool iterations "
        f"in {wall:.3f} s (m1 = {cfg.m1}, m2 = {cfg.m2}, ≤ {DF_MAX_ITER} "
        f"iterations); {flipped} view walks flipped their view before the "
        f"cap; best attack accuracy {res.best_attack_acc:.4f}; peak device "
        f"memory {peak:.3f} GiB")
    require(loops > 0, "NeRFail ran DeepFool")
    d = res.delta
    require(d.shape == mp["delta0"].shape and np.isfinite(d).all(),
            "NeRFail δ shape, finite")
    np.testing.assert_array_equal(d[..., 3], mp["delta0"][..., 3])
    require(np.abs(d[..., :3]).max() <= 255.0, "NeRFail δ clamp")
    return {"res": res, "loops": loops, "wall_s": wall, "peak_gb": peak,
            "cfg": cfg, "flipped": flipped}


def small_nerfail_cuda_vs_cpu(dev):
    """At 32²: NeRFail's CUDA path (K1, K2) against the port's CPU path.
    Same per-epoch control plane; δ within 1e-2 of 0-255 (fp32 sums in
    other orders, carried through the DeepFool steps)."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        make_classifier_logits_fn, zero_init_mask,
    )
    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.models.classifiers.simple_cnn import SimpleCNN

    size, n = 32, 6
    K, poses = scene(n, size)
    ori, S = views(K, poses, size)
    w, i, _ = tables(K, poses, S, size, torch.device("cpu"))
    torch.manual_seed(SEED)
    model = SimpleCNN(num_classes=N_CLASSES)
    delta0 = zero_init_mask(ori[list(MASK_VIEWS)].astype(np.float32)).numpy()
    cfg = AttackConfig(eps=EPS, m1=2.0, m2=10.0, df_max_iter=20,
                       view_batch=3)
    runs = {}
    for d in (dev, torch.device("cpu")):
        m = SimpleCNN(num_classes=N_CLASSES).to(d)
        m.load_state_dict(model.state_dict())
        runs[d.type] = nerfail_attack(
            delta0, w, i, ori, make_classifier_logits_fn(m), cfg,
            resize_to=None, epochs=3, device=d)
    keys = ("epoch", "m1", "m2", "attack_acc", "deepfool_calls")
    hist = {k: [{key: h[key] for key in keys} for h in r.history]
            for k, r in runs.items()}
    require(hist["cuda"] == hist["cpu"],
            f"small NeRFail history: {hist['cuda']} vs {hist['cpu']}")
    diff = float(np.abs(runs["cuda"].delta - runs["cpu"].delta).max())
    require(diff <= 1e-2, f"small NeRFail δ max difference {diff}")
    log(f"[check] 32² NeRFail CUDA path vs CPU path: {len(hist['cuda'])} "
        f"epochs, same m1/m2/attack_acc/deepfool_calls, max |Δδ| "
        f"{diff:.3e}: ok")


def quality_phase(dev):
    """tests/test_asr.py's fixture on the card, all in the port: SimpleCNN
    trained by train_classifier on the 64² box classes, then NeRFail and
    NeRFail-S against class 0."""
    import torch

    from nerfail_tpu_torch.attacks.forward import make_classifier_logits_fn
    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.eval import asr_fixture as fx

    # deterministic cuDNN algorithms: the same card and software train the
    # same classifier on every run (the attack kernels are deterministic)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    scenes, data = fx.box_classes()
    t0 = time.time()
    model, hist = fx.train_box_classifier(data, device=dev)
    torch.cuda.synchronize()
    log(f"[quality] SimpleCNN trained on {len(data['tr_y'])} images (64², "
        f"8 classes, Adam 1e-3, 40 epochs, batch 16) in "
        f"{time.time() - t0:.3f} s: val_acc {hist[-1]['val_acc']:.4f}")
    require(hist[-1]["val_acc"] >= 0.9, "trained classifier val_acc ≥ 0.9")
    logits_fn = make_classifier_logits_fn(model)
    tab = fx.attack_tables(scenes[0], dev)
    out = {"val_acc": hist[-1]["val_acc"]}
    for name, cfg in (("NeRFail", fx.NERFAIL_CFG),
                      ("NeRFail-S", fx.NERFAIL_S_CFG)):
        t0 = time.time()
        if name == "NeRFail":
            res = nerfail_attack(tab["delta0"], tab["wts"], tab["idxs"],
                                 tab["ori"], logits_fn, cfg, resize_to=None,
                                 device=dev)
        else:
            res = nerfail_s_attack(tab["delta0"], tab["wts"], tab["idxs"],
                                   tab["ori"], tab["labels"], logits_fn, cfg,
                                   resize_to=None, device=dev)
        torch.cuda.synchronize()
        rep = fx.acceptance(logits_fn, tab, res.delta, cfg.eps, dev)
        log(f"[quality] {name}, 64² / SimpleCNN (not the paper's setting), "
            f"{len(res.history)} epochs in {time.time() - t0:.3f} s, best "
            f"attack_acc {res.best_attack_acc:.4f}: {json.dumps(rep)}")
        require(rep["clean_acc_target_class"] >= 0.9, f"{name} clean acc")
        require(rep["asr"] >= 0.9, f"{name} ASR ≥ 0.9")
        require(rep["e_max"] <= cfg.eps + 1e-3, f"{name} e_max ≤ ε")
        out[name] = rep
    torch.backends.cudnn.deterministic = False
    return out


def _deepfool_batch0(dev, mp, delta, M):
    """Batch 0 of the NeRFail path: its batched plan (timed), the clean
    labels, and the engine's head."""
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        composite_after_splat, resize_batch, splat_attack_forward,
    )
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        build_batched_csr_plan,
    )

    sl = slice(0, BATCH)
    w, idx = mp["weights"][sl], mp["idx"][sl]
    ori = mp["ori_d"][sl].to(torch.float32)
    torch.cuda.synchronize()
    t0 = time.time()
    plan = build_batched_csr_plan(idx, w, M, pair_mask=ori[..., 3:] > 0)
    torch.cuda.synchronize()
    plan_ms = (time.time() - t0) * 1e3
    with torch.no_grad():
        ori_logits = splat_attack_forward(
            delta.reshape(-1, 4), w, idx, ori, mp["logits_fn"], eps=EPS,
            resize_to=RESIZE, device=dev)["ori_logits"]

    def head(pix):
        out = composite_after_splat(pix, ori, eps=EPS)
        return mp["logits_fn"](resize_batch(out["cla_x"], RESIZE))

    return {"w": w, "idx": idx, "ori": ori, "plan": plan,
            "plan_ms": plan_ms, "ori_logits": ori_logits,
            "ori_label": torch.argmax(ori_logits, -1), "head": head}


def k2_phase(dev, mp, df, M):
    """K2 on one real DeepFool iteration's Gdiff stack at full width
    ([8·800², 32]: 8 classes × RGBA), and K1 over the same batched plan
    as the engine's pick of that iteration, reading the chosen classes
    out of the stack in place (against the copy of the class followed by
    K1, the path before the in-place pick). Each also in plan-row order
    and in the Morton launch order, and on a plan that lists every one of
    the V·M rows."""
    import torch

    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        class_rows, error_bound, plan_point_ids, segment_sq,
        segment_sq_plain, segment_sum, segment_sum_class,
        segment_sum_class_plain, sq_error_bound,
    )
    from nerfail_tpu_torch.ops.splat import (
        deepfool_cotangents, splat_forward_batched,
    )

    delta = torch.from_numpy(df["res"].delta).to(dev)
    b = _deepfool_batch0(dev, mp, delta, M)
    plan = b["plan"]
    V = BATCH
    points_b = delta.reshape(1, M, 4).expand(V, M, 4).contiguous()
    with torch.no_grad():
        pix = splat_forward_batched(points_b, b["idx"], b["w"])
    logits, G = deepfool_cotangents(b["head"], pix, N_CLASSES,
                                    b["ori_label"])
    C = G.shape[1]
    log(f"[K2] batched plan for {V}×{H}² on the card: {b['plan_ms']:.3f} ms "
        f"(launch table included), {plan.n_pairs} kept pairs, {plan.n_rows} "
        f"touched rows of {V * M}; Gdiff stack {tuple(G.shape)}")

    k = segment_sq(G, plan)
    k2 = segment_sq(G, plan)
    ref = segment_sq_plain(G, plan)
    torch.cuda.synchronize()
    require(torch.equal(k, k2), "K2 bit-equal across runs")
    err = (k - ref).abs()
    bound = sq_error_bound(G, plan)
    require(bool((err <= bound).all()), "K2 within sq_error_bound")
    require(float(ref.max()) > 0, "K2 norms are not all zero")
    max_err = float(err.max())
    zplan = morton(plan)
    require(bool(((segment_sq(G, zplan) - ref).abs() <= bound).all()),
            "K2 in Morton launch order within sq_error_bound")

    ms = cuda_ms(lambda: segment_sq(G, plan), reps=20, warmup=2)
    morton_ms = cuda_ms(lambda: segment_sq(G, zplan), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: segment_sq_plain(G, plan), reps=3)
    pt = plan_point_ids(plan)
    contrib = plan.w[:, None] * G[plan.pix.long()]
    acc = torch.zeros(V * M, C, device=dev)

    def composite():
        acc.zero_()
        acc.index_add_(0, pt, contrib)
        return acc.view(V, M, C).square().sum(1)

    composite_ms = cuda_ms(composite, reps=3)
    del contrib, acc
    P, R = plan.n_pairs, plan.n_rows
    kept_pix = int((b["ori"][..., 3] > 0).sum())
    nbytes = 8 * P + 4 * C * kept_pix + 4 * (R + 1) + 4 * (V + 1) + 4 * V * C
    ops = 2 * P * C + 2 * R * C
    bound_ms = max(nbytes / PEAK_BYTES, ops / PEAK_FP32) * 1e3

    # K1 as the engine's pick: each view's class as deepfool_batch
    # chooses it from these logits and norms, read out of the stack
    views = torch.arange(V, device=dev)
    sq = k.view(V, N_CLASSES, 4).sum(-1)
    f = logits - logits[views, b["ori_label"]][:, None] - df["cfg"].m2
    value = f.abs() / (sq.sqrt() + 1e-4)
    value[views, b["ori_label"]] = float("inf")
    choice = value.argmin(-1)
    pk = segment_sum_class(G, choice, plan)
    pk2 = segment_sum_class(G, choice, plan)
    gsel = class_rows(G, choice, plan, 4)
    pref = segment_sum_class_plain(G, choice, plan)
    torch.cuda.synchronize()
    require(torch.equal(pk, pk2), "K1 pick bit-equal across runs")
    require(torch.equal(pk, segment_sum(gsel, plan)),
            "K1 pick in place bit-equal to K1 on the gathered class")
    require(torch.equal(pk, segment_sum_class(G, choice, zplan)),
            "K1 pick bit-equal in plan-row and Morton launch order")
    perr = (pk - pref).abs()
    require(bool((perr <= error_bound(gsel, plan)).all()),
            "K1 pick within the fp32 sum bound")
    untouched = torch.ones(V * M, dtype=torch.bool, device=dev)
    untouched[plan.rows.long()] = False
    require(bool((pk[untouched] == 0).all()), "K1 pick: untouched rows 0")
    require(bool(torch.isfinite(pk).all()) and float(pk.abs().max()) > 0,
            "K1 pick finite and not all zero")
    pick_max_err = float(perr.max())
    pick_ms = cuda_ms(lambda: segment_sum_class(G, choice, plan), reps=20,
                      warmup=2)
    pick_morton_ms = cuda_ms(
        lambda: segment_sum_class(G, choice, zplan), reps=20, warmup=2)
    pick_gsel_ms = cuda_ms(
        lambda: segment_sum(class_rows(G, choice, plan, 4), plan), reps=20,
        warmup=2)
    pick_plain_ms = cuda_ms(
        lambda: segment_sum_class_plain(G, choice, plan), reps=3)
    pick_nbytes = (8 * P + 4 * 4 * kept_pix + 4 * (2 * R + 1)
                   + 4 * 4 * V * M)
    pick_bound_ms = max(pick_nbytes / PEAK_BYTES,
                        2 * P * 4 / PEAK_FP32) * 1e3

    # the plan choice: every row listed (idle lane groups on empty rows)
    # K1 sums each row alone, so it is bit-equal; K2 adds the rows in
    # blocks of another grouping, so it is held to its bound
    full = every_row(plan)
    require(torch.equal(segment_sum_class(G, choice, full), pk),
            "K1 on every row equals K1 on the touched rows")
    require(bool(((segment_sq(G, full) - ref).abs()
                  <= sq_error_bound(G, full)).all()),
            "K2 on every row within sq_error_bound")
    full_ms = cuda_ms(lambda: segment_sq(G, full), reps=20, warmup=2)
    pick_full_ms = cuda_ms(lambda: segment_sum_class(G, choice, full),
                           reps=20, warmup=2)
    log(f"[K2] max |kernel − plain| {max_err:.3e} (≤ sq_error_bound, max "
        f"{float(bound.max()):.3e}; values up to {float(ref.max()):.3e}); "
        f"kernel {ms:.4f} ms (Morton order {morton_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, index_add_ + square + sum {composite_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms ({nbytes} bytes, {ops} flops)")
    log(f"[K1 pick] classes {choice.tolist()}: max |kernel − plain| "
        f"{pick_max_err:.3e} (values up to {float(pref.abs().max()):.3e}), "
        f"bit-equal across runs, to K1 on the gathered class and in Morton "
        f"order, untouched rows 0; in place {pick_ms:.4f} ms (zero-fill "
        f"included; Morton order {pick_morton_ms:.4f}), "
        f"class copy + K1 {pick_gsel_ms:.4f} ms, plain {pick_plain_ms:.4f} "
        f"ms, bound {pick_bound_ms:.4f} ms")
    log(f"[plan] DeepFool, touched rows vs every row: K2 {ms:.4f} vs "
        f"{full_ms:.4f} ms; K1 pick {pick_ms:.4f} vs {pick_full_ms:.4f} ms")
    return ({"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
             "library_ms": None, "composite_ms": composite_ms,
             "bound_ms": bound_ms,
             "bound_by": "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_FP32
             else "operations",
             "n_pairs": P, "n_rows": R, "plan_ms": b["plan_ms"],
             "every_row_ms": full_ms, "morton_ms": morton_ms},
            {"pick_max_abs_err": pick_max_err, "pick_ms": pick_ms,
             "pick_morton_ms": pick_morton_ms,
             "pick_class_copy_ms": pick_gsel_ms,
             "pick_plain_ms": pick_plain_ms,
             "pick_bound_ms": pick_bound_ms,
             "pick_every_row_ms": pick_full_ms})


def profile_deepfool(dev, mp, df, M):
    """One DeepFool walk of batch 0 (time per iteration), then one engine
    iteration split by CUDA events (forward and pullbacks, K2, the K1
    pick in place, and the pick as a class copy + K1 beside it) and under
    torch.profiler (device busy share, top kernels)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfail_tpu_torch.attacks.nerfail import make_batched_deepfool
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        class_rows, segment_sq, segment_sum, segment_sum_class,
    )
    from nerfail_tpu_torch.ops.splat import (
        deepfool_cotangents, splat_deepfool_engine, splat_forward_batched,
    )

    delta = torch.from_numpy(np.ascontiguousarray(mp["delta0"])).to(dev)
    b = _deepfool_batch0(dev, mp, delta, M)
    V, cfg = BATCH, df["cfg"]
    # every view's walk counts, finished or not, so the step is checked
    df_batch = make_batched_deepfool(mp["logits_fn"], cfg, RESIZE, N_CLASSES,
                                     accumulate_incomplete=True)
    torch.cuda.synchronize()
    t0 = time.time()
    rot, iters, _, _ = df_batch(
        delta, b["w"], b["idx"], b["ori"], b["ori_logits"],
        torch.ones(V, dtype=torch.bool, device=dev), cfg.m1, cfg.m2,
        b["plan"])
    torch.cuda.synchronize()
    walk_s = time.time() - t0
    loops = int(torch.clamp(iters + 1, max=cfg.df_max_iter).max())
    iter_ms = walk_s / loops * 1e3
    require(bool(torch.isfinite(rot).all()), "DeepFool rot finite")
    require(float(rot[..., :3].abs().max()) > 0, "DeepFool rot moved")
    require(bool((rot[..., 3] == 0).all()), "DeepFool rot keeps alpha")
    log(f"[deepfool] batch 0 walk from δ0: {loops} iterations in "
        f"{walk_s:.3f} s, {iter_ms:.3f} ms per iteration; iters per view "
        f"{iters.tolist()}; summed rot max |.| "
        f"{float(rot[..., :3].abs().max()):.3e}, finite, alpha 0: ok")

    points_b = delta.reshape(1, M, 4).expand(V, M, 4).contiguous()
    k = (b["ori_label"] + 1) % N_CLASSES
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    with torch.no_grad():
        pix = splat_forward_batched(points_b, b["idx"], b["w"])
    logits, G = deepfool_cotangents(b["head"], pix, N_CLASSES,
                                    b["ori_label"])
    ev[1].record()
    segment_sq(G, b["plan"])
    ev[2].record()
    segment_sum_class(G, k, b["plan"])
    ev[3].record()
    # the pick before the in-place launch: copy the classes, then K1
    segment_sum(class_rows(G, k, b["plan"], 4), b["plan"])
    ev[4].record()
    torch.cuda.synchronize()
    split = {"forward_and_pullbacks_ms": ev[0].elapsed_time(ev[1]),
             "k2_ms": ev[1].elapsed_time(ev[2]),
             "pick_ms": ev[2].elapsed_time(ev[3]),
             "pick_class_copy_ms": ev[3].elapsed_time(ev[4])}
    log(f"[deepfool] one engine iteration by CUDA events: {json.dumps(split)}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, _, pick = splat_deepfool_engine(
            b["head"], points_b, b["idx"], b["w"], b["plan"], N_CLASSES,
            b["ori_label"])
        pick(k)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    mine = {name: sum(e.self_device_time_total for e in kernels
                      if name in e.key) / 1e3
            for name in ("segsq_", "segsum_")}
    log(f"[profile] one DeepFool iteration: wall {wall_us / 1e3:.3f} ms, "
        f"device kernels {dev_us / 1e3:.3f} ms (K2 {mine['segsq_']:.3f}, K1 "
        f"{mine['segsum_']:.3f}), idle share "
        f"{(1 - dev_us / wall_us) if dev_us else 'not measured'}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:4d}× {e.key[:90]}")
    return {"iter_ms": iter_ms, **split}


def profile_step(dev, mp, M):
    """One steady NeRFail-S step (batch 0) under torch.profiler: device
    busy share of the step's wall time and the kernels that take it."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfail_tpu_torch.attacks.nerfail_s import make_nerfail_s_step
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import build_csr_plan

    sl = slice(0, BATCH)
    ori = mp["ori_d"][sl]
    batch = (mp["weights"][sl], mp["idx"][sl], ori,
             torch.zeros(BATCH, dtype=torch.int64, device=dev),
             torch.ones(BATCH, device=dev),
             build_csr_plan(mp["idx"][sl], mp["weights"][sl], M,
                            pair_mask=ori[..., 3:] > 0))
    step = make_nerfail_s_step(
        mp["logits_fn"], AttackConfig(eps=EPS, a=STEP_A, batch_size=BATCH),
        RESIZE)
    delta = torch.from_numpy(mp["res"].delta).to(dev)
    delta0 = torch.from_numpy(np.ascontiguousarray(mp["delta0"])).to(dev)
    step(delta, delta0, *batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(delta, delta0, *batch)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    log(f"[profile] one step: wall {wall_us / 1e3:.3f} ms, device kernels "
        f"{dev_us / 1e3:.3f} ms, idle share "
        f"{(1 - dev_us / wall_us) if dev_us else 'not measured'}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:4d}× {e.key[:90]}")


def _nerf_cfg(model=None, render=None, train=None):
    from nerfail_tpu_torch.config import (
        ExperimentConfig, NeRFModelConfig, RenderConfig, TrainConfig,
    )

    return ExperimentConfig(model=NeRFModelConfig(**(model or {})),
                            render=RenderConfig(**(render or {})),
                            train=TrainConfig(**(train or {})))


def _counts():
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import mlp_backward, mlp_forward

    return mlp_forward.launches, mlp_backward.launches


def _zero_counts():
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import mlp_backward, mlp_forward

    mlp_forward.launches = 0
    mlp_backward.launches = 0


def nerf_train_path(dev):
    """train_nerf at full width on the 800² box scene (8 train views),
    through the entry point; K4 and K5 launch twice per step."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import make_box_scene
    from nerfail_tpu_torch.train.nerf_trainer import train_nerf

    t0 = time.time()
    scene = make_box_scene(n_train=8, n_val=1, n_test=1, H=NERF_H, W=NERF_H)
    targets = white_background_composite(scene.images)
    log(f"[nerf] box scene, 10 views at {NERF_H}²: {time.time() - t0:.3f} s")
    cfg = _nerf_cfg(render=dict(N_samples=64, N_importance=128, chunk=32768),
                    train=dict(N_rand=1024, precrop_iters=10, i_print=1))
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.time()
    # i_print = 1: every step ends in a sync (float(loss)), so each log
    # carries that step's host-clock time
    state = train_nerf(cfg, targets, scene.poses, scene.K, scene.i_train,
                       n_iters=NERF_STEPS, device=dev,
                       log_fn=lambda i, m: steps.append((i, m)))
    torch.cuda.synchronize()
    wall = time.time() - t0
    k4, k5 = _counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses = [m["loss"] for _, m in steps]
    step_ms = [1e3 / m["steps_per_s"] for _, m in steps]
    steady = float(np.median(step_ms[10:]))
    log(f"[nerf train] {NERF_STEPS} steps in {wall:.3f} s; K4 {k4}, K5 {k5} "
        f"launches; loss {losses[0]:.5f} → {losses[-1]:.5f}; steady step "
        f"{steady:.3f} ms (median of steps 11-{NERF_STEPS}, host clock, each "
        f"ending in a sync), first step {step_ms[0]:.3f} ms; peak device "
        f"memory {peak:.3f} GiB")
    require(k4 == 2 * NERF_STEPS and k5 == 2 * NERF_STEPS,
            f"K4 and K5 twice per step ({2 * NERF_STEPS})")
    require(all(np.isfinite(v) for v in losses), "finite losses")
    return {"state": state, "cfg": cfg, "scene": scene, "targets": targets,
            "k4": k4, "k5": k5, "steady_ms": steady, "peak_gb": peak,
            "losses": losses}


def nerf_render_path(dev, nt, k4_ms_262k):
    """extract_coord_maps for one test view at full width: K4 twice per
    chunk. The view renders at 400² if the kernel's measured rate says
    800² would take longer than NERF_RENDER_LIMIT_S."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.pointset.extract import extract_coord_maps

    cfg, scene = nt["cfg"], nt["scene"]
    est_s = k4_ms_262k * 1e-3 * NERF_H * NERF_H * 256 / K45_POINTS
    size = NERF_H if est_s <= NERF_RENDER_LIMIT_S else NERF_H // 2
    K = scene.K.copy()
    K[:2] *= size / NERF_H
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.time()
    coords, rgbs = extract_coord_maps(nt["state"].params, cfg,
                                      scene.poses[scene.i_test[:1]], size,
                                      size, K)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    k4, k5 = _counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    chunks = -(-size * size // cfg.render.chunk)
    log(f"[nerf render] one {size}² view ({size * size} rays, {chunks} "
        f"chunks, K4 estimate for 800² {est_s:.3f} s): {render_s:.3f} s; K4 "
        f"{k4}, K5 {k5} launches; peak device memory {peak:.3f} GiB")
    require(k4 == 2 * chunks and k5 == 0, f"K4 twice per chunk ({chunks})")
    require(coords.shape == (1, size, size, 3) and np.isfinite(coords).all(),
            "pts_max finite [1, H, W, 3]")
    require(rgbs.min() >= -1e-5 and rgbs.max() <= 1 + 1e-5, "rgb in [0, 1]")
    return {"render_s": render_s, "size": size, "k4": k4, "peak_gb": peak}


def _library_mlp(xin, fw, fb, dims, requires_grad=False):
    """The same function in torch ops with bf16 torch.matmul (cuBLAS): a
    yardstick for K4/K5, timed here and never called by the port.
    Returns (out, leaves)."""
    import torch

    from nerfail_tpu_torch.ops.cuda.mlp_kernel import _encode, _split

    D = dims.depth
    ws = [w.to(torch.bfloat16).requires_grad_(requires_grad)
          for w in _split(fw, dims.w_shapes())]
    bs = [b.to(torch.bfloat16).requires_grad_(requires_grad)
          for b in _split(fb, [(n,) for n in dims.b_sizes()])]
    x = _encode(xin, dims.multires, 0, dims.in_pad)[0].to(torch.bfloat16)
    ed = _encode(xin, dims.multires_views, 4, dims.vd_pad)[0].to(
        torch.bfloat16)
    h = x
    for i in range(D):
        h = torch.relu(h @ ws[i] + bs[i])
        if i in dims.skips:
            h = torch.cat([x, h], -1)
    hv = torch.relu(torch.cat([h @ ws[D] + bs[D], ed], -1) @ ws[D + 1]
                    + bs[D + 1])
    out = (h @ ws[D + 2] + hv @ ws[D + 3])[:, :4].float()
    return out, ws + bs


def k45_phase(dev):
    """K4 and K5 against their plain versions at a train step's shapes:
    1024 rays × (64 coarse + 192 fine) samples = 262 144 points, 8×256,
    seeded inputs."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.models.nerf import init_nerf_params
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        K5Launch, MlpDims, _encode, _r, kernel_sizes, mlp_backward,
        mlp_backward_plain, mlp_forward, mlp_forward_plain, mlp_layer0_plain,
        pack_input, pack_params,
    )

    n = K45_POINTS
    cfg = NeRFModelConfig()
    dims = MlpDims.from_cfg(cfg)
    params = init_nerf_params(torch.Generator().manual_seed(SEED), cfg, dev)
    fw, fb = (t.detach().contiguous() for t in pack_params(params, dims))
    gen = torch.Generator().manual_seed(SEED + 1)
    # points in the cube the box scene's rays cross (cameras at radius 4)
    pts = torch.rand(n, 3, generator=gen) * 8.0 - 4.0
    vd = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    g = (torch.randn(n, 4, generator=gen) * 1e-3).to(dev)
    xin = pack_input(pts, vd).to(dev)

    # K4: output, bit-equality, layer 0's product
    z0 = torch.empty(n, dims.width, device=dev)
    out = mlp_forward(xin, fw, fb, dims, z0=z0)
    out2 = mlp_forward(xin, fw, fb, dims)
    ref = mlp_forward_plain(xin, fw, fb, dims)
    z0_ref = mlp_layer0_plain(xin, fw, fb, dims)
    enc = _r(_encode(xin, dims.multires, 0, dims.in_pad)[0])
    w0 = _r(fw[:dims.in_pad * dims.width].view(dims.in_pad, dims.width))
    # two f32 sums of K products of the same bf16 operands, each within
    # K·2u·Σ|a·b| of the exact sum (2u: truncating accumulation allowed)
    z0_bound = 2 * (dims.in_pad + 2) * 2.0 ** -23 * (
        enc.abs() @ w0.abs() + fb[:dims.width].abs())
    torch.cuda.synchronize()
    require(torch.equal(out, out2), "K4 bit-equal across launches")
    z0_err = (z0 - z0_ref).abs()
    require(bool((z0_err <= z0_bound).all()),
            "K4 layer 0 within the f32 summation bound")
    errs = {"out": (float((out - ref).abs().max()), float(ref.abs().max()))}

    # K5, as training runs it (no input gradients) and with them
    dx_none, dw, db = mlp_backward(xin, fw, fb, g, dims, False)
    _, dw2, db2 = mlp_backward(xin, fw, fb, g, dims, False)
    dx, dwi, dbi = mlp_backward(xin, fw, fb, g, dims, True)
    dx2, _, _ = mlp_backward(xin, fw, fb, g, dims, True)
    rx, rw, rb = mlp_backward_plain(xin, fw, fb, g, dims, True)
    torch.cuda.synchronize()
    require(dx_none is None, "K5 without input gradients gives None")
    require(torch.equal(dw, dw2) and torch.equal(db, db2)
            and torch.equal(dx, dx2), "K5 bit-equal across launches")
    require(torch.equal(dw, dwi) and torch.equal(db, dbi),
            "K5 dW/db do not depend on the input-gradient flag")
    errs["d_pts"] = (float((dx - rx).abs().max()), float(rx.abs().max()))
    names = [f"W{i}" for i in range(dims.depth)] + [
        "W_feature", "W_views", "W_alpha", "W_rgb"]
    o = 0
    for name, (k, m) in zip(names, dims.w_shapes()):
        a, b = dw[o:o + k * m], rw[o:o + k * m]
        errs[name] = (float((a - b).abs().max()), float(b.abs().max()))
        o += k * m
    o = 0
    for name, m in zip([f"b{i}" for i in range(dims.depth)]
                       + ["b_feature", "b_views"], dims.b_sizes()):
        a, b = db[o:o + m], rb[o:o + m]
        errs[name] = (float((a - b).abs().max()), float(b.abs().max()))
        o += m
    d_pts_rel = float((dx - rx).norm() / rx.norm())
    log("[K4/K5] max |kernel − plain| (tensor's largest entry): "
        + ", ".join(f"{k} {e:.3e} ({s:.3e})" for k, (e, s) in errs.items())
        + f"; d_pts relative L2 error {d_pts_rel:.3e}")
    # the same bf16 operands summed in another order; an activation whose
    # f32 value differs in its last bit may round to a bf16 one ulp (2⁻⁸)
    # away: 2 % of the tensor's largest entry. d_pts is held by its
    # relative L2 error (2 %): the encoding jacobian scales each channel by
    # up to 2⁹ and sums 63 terms that cancel, so its largest entries are
    # such cancellation residues
    for k, (e, scale) in errs.items():
        if k != "d_pts":
            require(e <= 0.02 * scale,
                    f"K4/K5 {k}: |kernel − plain| {e:.3e} vs scale {scale:.3e}")
    require(d_pts_rel <= 0.02, f"K4/K5 d_pts relative L2 error {d_pts_rel}")
    log(f"[K4] layer 0: max |kernel − plain| {float(z0_err.max()):.3e}, "
        f"within the f32 summation bound (max {float(z0_bound.max()):.3e}); "
        f"bit-equal across launches")

    ms4 = cuda_ms(lambda: mlp_forward(xin, fw, fb, dims), reps=10, warmup=2)
    plain4 = cuda_ms(lambda: mlp_forward_plain(xin, fw, fb, dims), reps=3)
    lib4 = cuda_ms(lambda: _library_mlp(xin, fw, fb, dims), reps=10,
                   warmup=2)
    ms5 = cuda_ms(lambda: mlp_backward(xin, fw, fb, g, dims, False),
                  reps=10, warmup=2)
    plain5 = cuda_ms(lambda: mlp_backward_plain(xin, fw, fb, g, dims, False),
                     reps=3)

    # K5's two kernels apart, on one set of buffers: K5a (recompute,
    # backward, stash, db) and K5b (dW from the stash)
    k5 = K5Launch.prepare(xin, fw, fb, g, dims, False)
    ms5a = cuda_ms(k5.pass_, reps=10, warmup=2)
    ms5b = cuda_ms(k5.wgrad, reps=10, warmup=2)
    del k5
    # K5's device memory above its inputs, as training calls it
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mlp_backward(xin, fw, fb, g, dims, False)
    torch.cuda.synchronize()
    k5_peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    stash_gib = 2 * n * kernel_sizes(dims)[2] / 2 ** 30
    log(f"[K5] {n} points: K5a (recompute + backward + stash) {ms5a:.4f} ms, "
        f"K5b (dW GEMM from the stash, split-K sum included) {ms5b:.4f} ms; "
        f"device memory above the inputs {k5_peak:.3f} GiB, of which the "
        f"per-point stash {stash_gib:.3f} GiB")

    def lib_fwd_bwd():
        out, leaves = _library_mlp(xin, fw, fb, dims, requires_grad=True)
        return torch.autograd.grad(out, leaves, g)

    lib5 = cuda_ms(lib_fwd_bwd, reps=10, warmup=2)

    macs = dims.macs_per_point()
    layer0 = dims.in_pad * dims.width
    w_bytes = 2 * fw.numel() + 4 * fb.numel()
    flops4 = 2 * n * macs
    bytes4 = n * (32 + 16) + w_bytes
    # recompute (1×), weight gradients (1×), activation gradients (1×
    # without layer 0's: no input gradients in training)
    flops5 = 2 * n * (3 * macs - layer0)
    bytes5 = n * (32 + 16) + w_bytes + 4 * (fw.numel() + fb.numel())
    rows = {}
    for name, ms, plain, lib, fl, by, lib_note in (
            ("K4", ms4, plain4, lib4, flops4, bytes4, "forward"),
            ("K5", ms5, plain5, lib5, flops5, bytes5,
             "forward + backward (K5 recomputes the forward)")):
        t_ops, t_bytes = fl / PEAK_BF16, by / PEAK_BYTES
        rows[name] = {"max_abs_err": max(e for k, (e, _) in errs.items()
                                         if (k == "out") == (name == "K4")),
                      "ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": max(t_ops, t_bytes) * 1e3,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "points": n, "flops": fl}
        log(f"[{name}] {n} points: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bf16 torch.matmul {lib_note} {lib:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.4f} ms ({fl:.4e} flops at 989 TF/s, "
            f"{by} bytes); {fl / ms / 1e9:.2f} TFLOP/s achieved")
    rows["K4"]["layer0_max_abs_err"] = float(z0_err.max())
    sizes = kernel_sizes(dims)
    rows["K4"].update(
        tflops=flops4 / ms4 / 1e9, bound_share=rows["K4"]["bound_ms"] / ms4,
        ring_stages=sizes[6], smem_bytes=sizes[3],
        parts=["mlp_fwd_ws_kernel<W>: persistent, min(SMs, tiles) blocks of "
               "384 threads, tiles of 128 points",
               "consumer warpgroups 0 and 1: 64 rows each, wgmma m64nNk16 "
               "from shared memory (128-byte swizzle), setmaxnreg 232",
               "producer warpgroup: one thread issues one cp.async.bulk per "
               "ring stage, setmaxnreg 40",
               f"ring: {sizes[6]} stages of {128 * dims.width} bytes (one "
               "K-slice of <= 64 rows of one matrix each)",
               "multicast: off (one block per cluster)"],
        small=k4_small_inputs(dev))
    log(f"[K4] {rows['K4']['tflops']:.2f} TFLOP/s, {rows['K4']['bound_share']:.4f} "
        f"of its bound; ring {sizes[6]} stages, {sizes[3]} bytes of shared "
        f"memory a block; at the 64² quality run's shapes: "
        + ", ".join(f"{r['points']} points {r['ms']:.4f} ms through "
                    f"mlp_forward, {r['launch_ms']:.4f} ms the launch alone "
                    f"({r['tflops']:.2f} TFLOP/s)" for r in rows["K4"]["small"]))
    rows["K5"].update(d_pts_rel_l2=d_pts_rel, k5a_ms=ms5a, k5b_ms=ms5b,
                      peak_gib=k5_peak, stash_gib=stash_gib)
    # the same launch through utils/profiling.roofline (the card's peaks
    # looked up by name)
    from nerfail_tpu_torch.utils.profiling import roofline

    rl = roofline(mlp_forward, xin, fw, fb, dims, flops=flops4,
                  bytes_accessed=bytes4, iters=10, warmup=2)
    log(f"[K4] utils/profiling.roofline at {n} points: {rl} (this phase's "
        f"CUDA-event time {ms4:.4f} ms, bound {rows['K4']['bound_ms']:.4f} "
        f"ms)")
    rows["K4"]["roofline"] = {
        "ms": rl.seconds * 1e3, "bound_ms": rl.bound_seconds * 1e3,
        "bound_by": rl.bound, "flops_utilization": rl.flops_utilization}
    return rows


def k4_small_inputs(dev):
    """K4 at the 64² quality run's launches (4×128 MLP; 512 rays × 32
    coarse and × 64 fine samples; 128 and 256 tiles): one or two tiles a
    block, so the persistent schedule has little to overlap. Timed through
    `mlp_forward` (as the path calls it: packing, checks) and as the
    kernel's launch alone."""
    import torch

    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.models.nerf import init_nerf_params
    from nerfail_tpu_torch.ops.cuda import build
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        MlpDims, _lib, mlp_forward, pack_input, pack_params, pack_stream,
    )

    cfg = NeRFModelConfig(netdepth=4, netwidth=128)
    dims = MlpDims.from_cfg(cfg)
    params = init_nerf_params(torch.Generator().manual_seed(SEED), cfg, dev)
    fw, fb = (t.detach().contiguous() for t in pack_params(params, dims))
    out = []
    for n in (512 * 32, 512 * 64):
        gen = torch.Generator().manual_seed(SEED + n)
        pts = torch.rand(n, 3, generator=gen) * 8.0 - 4.0
        vd = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen),
                                           dim=-1)
        xin = pack_input(pts, vd).to(dev)
        ms = cuda_ms(lambda: mlp_forward(xin, fw, fb, dims), reps=20,
                     warmup=3)
        # the kernel's launch alone: the weights packed once, no checks
        wp, res = pack_stream(fw, dims), torch.empty(n, 4, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            build.check(_lib().nerf_mlp_fwd_launch(
                dims.array(), xin.data_ptr(), wp.data_ptr(), fb.data_ptr(),
                res.data_ptr(), None, n, stream), "nerf_mlp_fwd_launch")

        launch_ms = cuda_ms(launch, reps=20, warmup=3)
        flops = 2 * n * dims.macs_per_point()
        out.append({"points": n, "ms": ms, "launch_ms": launch_ms,
                    "tflops": flops / launch_ms / 1e9,
                    "bound_ms": flops / PEAK_BF16 * 1e3})
    return out


def ptxas_counts(log_text: str, kernel: str):
    """{template argument or "": (registers, spill store bytes, spill load
    bytes)} of `kernel` in an nvcc -Xptxas -v log."""
    import re

    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            cur = None
            if kernel in name:
                t = re.search(kernel + r"ILi(\d+)E", name)
                cur = t.group(1) if t else ""
                out[cur] = [None, None, None]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def nerf_quality(dev):
    """The verify recipe's 64² NeRF through K4/K5: test PSNR, pts_max
    against the analytic surface, and K3 tables from 3 NeRF coordinate
    maps (self-distance of a mask view)."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import (
        _ray_box, analytic_coord_map, make_box_scene,
    )
    from nerfail_tpu_torch.ops.rays import get_rays_np
    from nerfail_tpu_torch.pointset.extract import (
        build_neighbor_tables, build_point_set, extract_coord_maps,
    )
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
    from nerfail_tpu_torch.render import render_full_image
    from nerfail_tpu_torch.train.nerf_trainer import eval_psnr, train_nerf

    scene = make_box_scene(20, 2, 4, 64, 64)
    targets = white_background_composite(scene.images)
    cfg = _nerf_cfg(model=dict(netdepth=4, netwidth=128),
                    render=dict(N_samples=32, N_importance=32),
                    train=dict(N_rand=512, i_print=500))
    _zero_counts()
    t0 = time.time()
    state = train_nerf(cfg, targets, scene.poses, scene.K, scene.i_train,
                       n_iters=QUALITY_STEPS, device=dev,
                       log_fn=lambda i, m: log(f"[nerf quality] step {i}: "
                                               f"{json.dumps(m)}"))
    torch.cuda.synchronize()
    train_s = time.time() - t0
    k4, k5 = _counts()
    require(k4 == k5 == 2 * QUALITY_STEPS, "quality run through K4/K5")
    psnr = eval_psnr(state, cfg, targets, scene.poses, scene.K, scene.i_test)
    dists = []
    for i in scene.i_test:
        out = render_full_image(state.params["coarse"], state.params["fine"],
                                cfg.model, cfg.render, 64, 64, scene.K,
                                scene.poses[i])
        o, d = get_rays_np(64, 64, scene.K, scene.poses[i])
        _, hit = _ray_box(o.reshape(-1, 3), d.reshape(-1, 3))
        keep = hit & (out["acc_map"].cpu().numpy().reshape(-1) > 0.5)
        gt = analytic_coord_map(scene.poses[i], 64, 64, scene.K).reshape(-1, 3)
        pm = out["pts_max"].cpu().numpy().reshape(-1, 3)
        dists.append(np.linalg.norm(pm[keep] - gt[keep], axis=-1))
    dists = np.concatenate(dists)
    med, p90 = float(np.median(dists)), float(np.percentile(dists, 90))
    coords, _ = extract_coord_maps(state.params, cfg,
                                   scene.poses[scene.i_test[:3]], 64, 64,
                                   scene.K)
    S = build_point_set(coords)
    w, idx = build_neighbor_tables(coords, S, device=dev)
    d0, _ = build_index_and_dist(coords[0], S, device=dev)
    self_max = float(d0[..., 0].max())
    log(f"[nerf quality] 64² box scene, 4×128 MLP, 32 + 32 samples, 512 "
        f"rays, {QUALITY_STEPS} steps in {train_s:.3f} s: test PSNR "
        f"{psnr:.4f} dB; pts_max vs the analytic surface on {dists.size} hit "
        f"pixels with acc > 0.5: median {med:.5f}, 90th percentile "
        f"{p90:.5f}; tables from 3 NeRF maps (M = {S.shape[0]}) by K3: "
        f"weight sums ≤ {float(w.sum(-1).max()):.5f}, self-distance of mask "
        f"view 0 max {self_max:.3e}")
    require(psnr >= 20.0, "64² NeRF test PSNR ≥ 20 dB")
    require(med < 0.1, "pts_max median distance < 0.1 on hit pixels")
    require(self_max == 0.0, "mask view self-distance 0")
    require(idx.shape == (3, 64, 64, 8), "tables shape")
    return {"psnr": psnr, "median": med, "p90": p90, "train_s": train_s,
            "hit_pixels": int(dists.size)}


def nerf_cuda_vs_cpu(dev):
    """train_nerf at 16² (2×64 MLP, 20 steps) on the card (K4/K5) and on
    the CPU (their plain versions), fed the same rays and uniforms."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import make_box_scene
    from nerfail_tpu_torch.train.nerf_trainer import sample_rays, train_nerf

    scene = make_box_scene(6, 1, 1, 16, 16)
    targets = white_background_composite(scene.images)
    # use_pallas=True: the CPU run takes the fused MLP's plain version
    # (None would take the f32 unfused path there, as the reference does)
    cfg = _nerf_cfg(model=dict(netdepth=2, netwidth=64),
                    render=dict(N_samples=16, N_importance=16,
                                use_pallas=True),
                    train=dict(N_rand=256, precrop_iters=5, i_print=1))
    imgs = torch.from_numpy(targets[scene.i_train])
    poses = torch.from_numpy(scene.poses[scene.i_train])
    K = torch.from_numpy(scene.K)

    def sampler(i, precrop):
        gen = torch.Generator().manual_seed(1000 + i)
        b = sample_rays(gen, imgs, poses, K, 256, precrop, 0.5, True)
        b["t_rand"] = torch.rand(256, 16, generator=gen)
        b["u_pdf"] = torch.rand(256, 16, generator=gen)
        return b

    hist = {}
    for d in (dev, torch.device("cpu")):
        h = []
        train_nerf(cfg, targets, scene.poses, scene.K, scene.i_train,
                   n_iters=20, device=d, sampler=sampler,
                   log_fn=lambda i, m: h.append(m["loss"]))
        hist[d.type] = np.array(h)
    rel = np.abs(hist["cuda"] - hist["cpu"]) / hist["cpu"]
    log(f"[check] 16² train_nerf CUDA (K4/K5) vs CPU (plain versions), same "
        f"rays and uniforms: losses {hist['cuda'][0]:.6f} → "
        f"{hist['cuda'][-1]:.6f}; max relative difference {rel.max():.3e}")
    # both round the same operands to bf16 and sum in other orders: the
    # per-step loss within 1 % over 20 steps of Adam
    require(float(rel.max()) <= 1e-2, "16² loss histories agree within 1 %")
    return float(rel.max())


def profile_nerf_step(dev, nt):
    """One steady full-width train step under torch.profiler: device busy
    share and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfail_tpu_torch.train.nerf_trainer import (
        make_train_step, sample_rays,
    )

    cfg, state, scene = nt["cfg"], nt["state"], nt["scene"]
    imgs = torch.as_tensor(nt["targets"][scene.i_train], device=dev)
    poses = torch.as_tensor(scene.poses[scene.i_train], device=dev)
    K = torch.as_tensor(scene.K, device=dev)
    step = make_train_step(cfg.model, cfg.render, cfg.train)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def one():
        b = sample_rays(gen, imgs, poses, K, cfg.train.N_rand, False, 0.5,
                        True)
        step(state, b, gen, (NERF_H, NERF_H), float(scene.K[0, 0]))

    one()
    torch.cuda.synchronize()
    t0 = time.time()
    one()
    torch.cuda.synchronize()
    plain_wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        one()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    mine = {name: sum(e.self_device_time_total for e in kernels
                      if name in e.key) / 1e3
            for name in ("mlp_fwd_ws_kernel", "mlp_bwd_pass_kernel",
                         "mlp_wgrad_kernel", "reduce_parts_kernel")}
    k5_ms = (mine["mlp_bwd_pass_kernel"] + mine["mlp_wgrad_kernel"]
             + mine["reduce_parts_kernel"])
    log(f"[profile] one NeRF train step: unprofiled wall {plain_wall_ms:.3f} "
        f"ms; profiled wall {wall_us / 1e3:.3f} ms, device kernels "
        f"{dev_us / 1e3:.3f} ms (K4 {mine['mlp_fwd_ws_kernel']:.3f}; K5 "
        f"{k5_ms:.3f} = K5a {mine['mlp_bwd_pass_kernel']:.3f} + K5b "
        f"{mine['mlp_wgrad_kernel']:.3f} + split sums "
        f"{mine['reduce_parts_kernel']:.3f}, "
        f"{k5_ms / (dev_us / 1e3) if dev_us else 'not measured'} of device "
        f"time), idle share "
        f"{(1 - dev_us / wall_us) if dev_us else 'not measured'}; "
        f"1 − device / unprofiled wall "
        f"{(1 - dev_us / 1e3 / plain_wall_ms) if dev_us else 'not measured'}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:4d}× {e.key[:90]}")
    # a renamed kernel would match nothing and read as 0 ms
    for name in ("mlp_fwd_ws_kernel", "mlp_bwd_pass_kernel", "mlp_wgrad_kernel"):
        require(mine[name] > 0, f"profiled step shows {name} with device time")
    return {"wall_ms": plain_wall_ms, "device_ms": dev_us / 1e3,
            "k5_ms": k5_ms, **mine}


MULTI_K = 10                   # steps per captured window
MULTI_WINDOWS = 5              # replays timed after the checked one


def multi_step_phase(dev, nt):
    """make_multi_train_step at full width on nerf_train_path's 800² box
    scene (8 train views, 8×256, 64 + 128 samples, 1024 rays; precrop
    off): one window of MULTI_K steps captured as a CUDA graph and
    replayed, held bit-equal against MULTI_K eager make_train_step steps
    on the card with the same (seed, i) draws and the same capturable
    Adam (make_capturable, as the capture converts the state's); eager
    step times of the plain Adam that train_nerf steps, and replayed step
    times (CUDA events and host wall); the idle share of one replay from
    utils/profiling.device_trace, and device memory. K4 and K5 are counted
    through their wrappers (the warm-up step and the capture, 2 + 2k
    each; none in a replay) and, in the profiled replay, as the kernels
    the graph launched (2k each)."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, make_capturable, make_multi_train_step,
        make_train_step, sample_rays, step_seed,
    )
    from nerfail_tpu_torch.utils.profiling import device_trace

    cfg, scene = nt["cfg"], nt["scene"]
    mcfg, rcfg = cfg.model, cfg.render
    tcfg = dataclasses.replace(cfg.train, precrop_iters=0)
    imgs = torch.as_tensor(nt["targets"][scene.i_train], device=dev)
    poses = torch.as_tensor(scene.poses[scene.i_train], device=dev)
    K = torch.as_tensor(scene.K, dtype=torch.float32, device=dev)
    hw, focal, k = (NERF_H, NERF_H), float(scene.K[0, 0]), MULTI_K
    step = make_train_step(mcfg, rcfg, tcfg)
    gen = torch.Generator(device=dev)

    def eager(st, i):
        gen.manual_seed(step_seed(SEED, i))
        batch = sample_rays(gen, imgs, poses, K, tcfg.N_rand, False,
                            tcfg.precrop_frac, tcfg.no_batching)
        return step(st, batch, gen, hw, focal)

    # the reference: k eager steps of the capturable Adam the window steps
    ref = create_train_state(SEED, mcfg, rcfg, tcfg, dev)
    make_capturable(ref.opt_state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(k):
        m_ref = eager(ref, i)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    snap = {n: {key: v.detach().clone() for key, v in ref.params[n].items()}
            for n in ("coarse", "fine")}
    loss_ref = float(m_ref["loss"])
    del ref

    # the eager step as train_nerf takes it (plain Adam): k warm-up steps,
    # then k timed
    plain = create_train_state(SEED, mcfg, rcfg, tcfg, dev)
    for i in range(k):
        eager(plain, i)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.time()
    ev0.record()
    for i in range(k, 2 * k):
        eager(plain, i)
    ev1.record()
    torch.cuda.synchronize()
    eager_wall_ms = (time.time() - t0) * 1e3 / k
    eager_ev_ms = ev0.elapsed_time(ev1) / k
    del plain

    # the captured window from the same start
    state = create_train_state(SEED, mcfg, rcfg, tcfg, dev)
    multi = make_multi_train_step(mcfg, rcfg, tcfg, precrop=False, k=k)
    torch.cuda.synchronize()
    # the capture empties the allocator's cache (torch.cuda.graph), so
    # start from an empty one: what is reserved after it is the graph's
    # private pool beside the live tensors
    torch.cuda.empty_cache()
    base_reserved = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.time()
    m = multi(state, imgs, poses, K, SEED)
    torch.cuda.synchronize()
    capture_s = time.time() - t0
    k4, k5 = _counts()
    capture_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    graph_reserved = (torch.cuda.memory_reserved(dev) - base_reserved) / 2 ** 30
    require((k4, k5) == (2 + 2 * k, 2 + 2 * k),
            f"K4 and K5 launched by the warm-up step and recorded 2k times "
            f"each by the capture: {(k4, k5)}")
    diffs = {}
    for n in ("coarse", "fine"):
        for key, v in snap[n].items():
            diffs[f"{n}/{key}"] = float(
                (state.params[n][key].detach() - v).abs().max())
    equal = all(torch.equal(state.params[n][key], v)
                for n in ("coarse", "fine") for key, v in snap[n].items())
    log(f"[multi-step] captured window of {k} steps vs {k} eager "
        f"make_train_step steps of the same capturable Adam on the card, "
        f"same (seed, i) draws: parameters bit-equal {equal}, max |Δ| "
        f"{max(diffs.values()):.3e}; loss {float(m['loss']):.7f} vs "
        f"{loss_ref:.7f}; first call (warm-up step + capture + replay) "
        f"{capture_s:.3f} s; K4 {k4}, K5 {k5} wrapper launches")
    require(equal and float(m["loss"]) == loss_ref,
            "the captured window equals the eager loop bit for bit")

    # replays: CUDA events and host wall per step; no wrapper runs in them
    _zero_counts()
    ev0.record()
    t0 = time.time()
    for _ in range(MULTI_WINDOWS):
        m = multi(state, imgs, poses, K, SEED)
    ev1.record()
    torch.cuda.synchronize()
    graph_wall_ms = (time.time() - t0) * 1e3 / (MULTI_WINDOWS * k)
    graph_ev_ms = ev0.elapsed_time(ev1) / (MULTI_WINDOWS * k)
    replay_counts = _counts()
    require(replay_counts == (0, 0),
            f"replays launch K4 and K5 from the graph, through no wrapper: "
            f"{replay_counts}")
    require(state.step == (1 + MULTI_WINDOWS) * k
            and bool(torch.isfinite(m["loss"])), "replays advance the step")

    # one replay under the profiler: device busy and idle share, and the
    # kernels the graph launched
    with tempfile.TemporaryDirectory() as tdir:
        with device_trace(tdir) as prof:
            t0 = time.time()
            multi(state, imgs, poses, K, SEED)
            torch.cuda.synchronize()
            wall_us = (time.time() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    k45 = ("mlp_fwd_ws_kernel", "mlp_bwd_pass_kernel", "mlp_wgrad_kernel",
           "reduce_parts_kernel")
    k45_us = sum(e.self_device_time_total for e in kernels
                 if any(n in e.key for n in k45))
    graph_counts = {n: sum(e.count for e in kernels if n in e.key)
                    for n in k45}
    idle = (1 - dev_us / wall_us) if dev_us else "not measured"
    log(f"[multi-step] {card_line()}: step time eager {eager_ev_ms:.4f} ms "
        f"(CUDA events) / {eager_wall_ms:.4f} ms (host wall), replayed "
        f"graph {graph_ev_ms:.4f} ms / {graph_wall_ms:.4f} ms, over "
        f"{MULTI_WINDOWS} windows of {k}; one profiled replay: wall "
        f"{wall_us / 1e3:.3f} ms, device kernels {dev_us / 1e3:.3f} ms "
        f"(K4/K5 {k45_us / 1e3:.3f} ms), idle share {idle}; peak allocated "
        f"{capture_peak:.3f} GiB over the warm-up step and the capture, "
        f"graph pool reserved {graph_reserved:.3f} GiB, eager step "
        f"peak {eager_peak:.3f} GiB; kernels launched by the profiled "
        f"replay {graph_counts}")
    require(dev_us > 0, "the profiled replay shows device time")
    require(graph_counts == {"mlp_fwd_ws_kernel": 2 * k,
                             "mlp_bwd_pass_kernel": 2 * k,
                             "mlp_wgrad_kernel": 2 * k,
                             "reduce_parts_kernel": 4 * k},
            f"the profiled replay launched K4 2k times and K5's kernels 2k "
            f"times each (its split sums 4k): {graph_counts}")
    return {"k": k, "eager_ms": eager_ev_ms, "eager_wall_ms": eager_wall_ms,
            "graph_ms": graph_ev_ms, "graph_wall_ms": graph_wall_ms,
            "idle_share": idle, "device_ms": dev_us / 1e3,
            "wall_ms": wall_us / 1e3, "capture_s": capture_s,
            "capture_peak_gib": capture_peak,
            "graph_reserved_gib": graph_reserved, "eager_peak_gib": eager_peak,
            "k4": k4, "k5": k5,
            "graph_k4": graph_counts["mlp_fwd_ws_kernel"],
            "graph_k5": graph_counts["mlp_bwd_pass_kernel"],
            "max_abs_diff": max(diffs.values())}


def import_phase(dev):
    """The reference's InceptionResNetV2 weights, regenerated from the
    golden's (kind, shape) sequence as tests/test_classifier_parity.py
    does (seed 7), imported by models/classifiers/torch_import into the
    port's model on the card; its logits on the golden's input against
    the reference's (fp32, TF32 off) at rtol 2e-3 and atol 2e-3 × the
    largest logit."""
    import os

    import numpy as np
    import torch

    from nerfail_tpu_torch.models.classifiers.incresv2 import (
        InceptionResNetV2,
    )
    from nerfail_tpu_torch.models.classifiers.torch_import import (
        import_torch_state, torch_tensor_shapes,
    )

    g = np.load(os.path.join("tests", "golden", "reference_goldens.npz"))
    kinds = json.loads(bytes(g["incresv2/kinds_json"]).decode())
    rng = np.random.default_rng(7)
    tensors = []
    for kind, shape in kinds:       # tests/test_classifier_parity.py
        if kind in ("bn_var", "bn_scale"):
            t = rng.uniform(0.5, 1.5, shape)
        elif kind == "bn_mean":
            t = rng.standard_normal(shape) * 0.1
        elif kind.endswith("_kernel"):
            t = rng.standard_normal(shape) * 0.05
        else:
            t = rng.standard_normal(shape) * 0.02
        tensors.append(t.astype(np.float32))
    t0 = time.time()
    model = InceptionResNetV2(num_classes=N_CLASSES).to(dev).eval()
    seq = torch_tensor_shapes(model)
    require([(k, list(s)) for k, s in seq] == [(k, list(s)) for k, s in kinds],
             "torch_tensor_shapes equals the golden's kinds_json")
    import_torch_state(model, tensors)
    torch.cuda.synchronize()
    import_s = time.time() - t0
    with torch.no_grad():
        got = model(torch.as_tensor(g["incresv2/input"], device=dev))
    got = got.cpu().numpy()
    want = g["incresv2/logits"]
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    ok = bool(np.all(np.abs(got - want) <= 2e-3 * scale + 2e-3 * np.abs(want)))
    log(f"[import] reference InceptionResNetV2 tensors ({len(tensors)}) into "
        f"the port's model on the card in {import_s:.3f} s; logits vs the "
        f"reference's: max |Δ| {err:.3e} (largest logit {scale:.3e}), within "
        f"rtol 2e-3 / atol 2e-3·scale {ok}")
    require(ok, "imported InceptionResNetV2 logits match the reference's")
    return {"tensors": len(tensors), "max_abs_err": err, "scale": scale,
            "import_s": import_s}


def annotate_phase(dev, ori, mp):
    """evaluate_testset with annotate_dir on 4 of the main path's clean
    800² views, classified at 299² by the trained Inception-V3 and drawn
    at 800² (annotate_images): the files r_<i>.png, their size, the
    pixels outside the text box untouched, the text in the predicted
    class's colour."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import white_composite_255
    from nerfail_tpu_torch.eval.harness import (
        ANNOTATE_COLORS, annotation_text, evaluate_testset, logits_all,
    )
    from nerfail_tpu_torch.utils.font import CELL, ROWS, dot_size
    from nerfail_tpu_torch.utils.png import imread

    n, idx = 4, np.array([0, 5, 10, 15])
    x = torch.as_tensor(ori[idx], device=dev).to(torch.float32)
    big = white_composite_255(x[..., :3], x[..., 3:4]).cpu().numpy()
    small = np.asarray(mp["clean"])[idx]
    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "annotated_test")
        t0 = time.time()
        rep = evaluate_testset(mp["logits_fn"], small, np.zeros(n, np.int64),
                               attacked_class=0, num_classes=N_CLASSES,
                               batch_size=n, annotate_dir=out,
                               annotate_images=big, indices=idx, device=dev)
        wall = time.time() - t0
        names = sorted(os.listdir(out))
        require(names == sorted(f"r_{i}.png" for i in idx),
                f"annotated files {names}")
        logits = logits_all(mp["logits_fn"], small, n, dev)
        d = dot_size(max(H / 800.0, 0.3))
        for j, (pred, text) in enumerate(annotation_text(logits)):
            img = imread(os.path.join(out, f"r_{idx[j]}.png"))
            base = np.clip(big[j], 0, 255).astype(np.uint8)
            require(img.shape == (H, H, 3), "annotated view is 800² RGB")
            y1, x0 = H // 8 + 1, H // 8
            box = np.zeros((H, H), bool)
            box[y1 - ROWS * d:y1, x0:x0 + CELL * d * len(text)] = True
            changed = (img != base).any(-1)
            colour = (img == np.asarray(ANNOTATE_COLORS[pred],
                                        np.uint8)).all(-1)
            require(not changed[~box].any() and changed[box].any()
                    and not (changed & ~colour).any(),
                    f"r_{idx[j]}.png: '{text}' drawn in its box in the "
                    f"class colour, nothing else changed")
    log(f"[annotate] evaluate_testset wrote {names} ({H}², labels "
        f"{[t for _, t in annotation_text(logits)]}) in {wall:.3f} s; ASR "
        f"{rep['asr']:.4f}")
    return {"files": names, "wall_s": wall}


def zoo_phase(dev):
    """Every registry entry at its input size, eval mode, seeded torch
    init: forward and the input gradient of the cross-entropy at batch
    ZOO_BATCH on the card (finite; CUDA-event times, peak memory), and
    the CUDA logits of one image within 1e-3 of the CPU's largest logit
    (fp32 with TF32 off, summed in other orders)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from nerfail_tpu_torch.models.classifiers import (
        CLASSIFIER_REGISTRY, classifier_input_size, get_classifier,
    )

    out = {}
    for name in CLASSIFIER_REGISTRY:
        t0 = time.time()
        size = classifier_input_size(name) or 800   # None: the raw 800²
        torch.manual_seed(SEED)
        cpu_model = get_classifier(name, N_CLASSES).eval()
        cpu_model.requires_grad_(False)
        model = get_classifier(name, N_CLASSES).eval().requires_grad_(False)
        model.load_state_dict(cpu_model.state_dict())
        model.to(dev)
        x = torch.from_numpy(np.random.default_rng(SEED).uniform(
            0, 255, (ZOO_BATCH, size, size, 3)).astype(np.float32))
        y = torch.arange(ZOO_BATCH, device=dev) % N_CLASSES
        xd = x.to(dev)

        def fwd():
            with torch.no_grad():
                return model(xd)

        def fwd_bwd():
            xg = xd.clone().requires_grad_(True)
            return torch.autograd.grad(F.cross_entropy(model(xg), y), xg)[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        logits, grad = fwd(), fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        require(tuple(logits.shape) == (ZOO_BATCH, N_CLASSES)
                and bool(torch.isfinite(logits).all()), f"{name} logits")
        require(tuple(grad.shape) == tuple(x.shape)
                and bool(torch.isfinite(grad).all())
                and float(grad.abs().max()) > 0, f"{name} input gradient")
        fwd_ms = cuda_ms(fwd, reps=3)
        fwd_bwd_ms = cuda_ms(fwd_bwd, reps=3)
        with torch.no_grad():
            want = cpu_model(x[:1])
        err = float((logits[:1].cpu() - want).abs().max())
        scale = float(want.abs().max())
        require(err <= 1e-3 * scale,
                f"{name}: CUDA logits within 1e-3 of the CPU's ({err:.3e} "
                f"of {scale:.3e})")
        out[name] = {"size": size, "forward_ms": fwd_ms,
                     "backward_ms": fwd_bwd_ms - fwd_ms,
                     "forward_backward_ms": fwd_bwd_ms, "peak_gb": peak,
                     "cuda_vs_cpu_max_abs": err, "logit_scale": scale,
                     "wall_s": time.time() - t0}
        log(f"[zoo] {name} at {size}², batch {ZOO_BATCH}: forward "
            f"{fwd_ms:.3f} ms, input-gradient backward "
            f"{fwd_bwd_ms - fwd_ms:.3f} ms (forward + backward "
            f"{fwd_bwd_ms:.3f}), peak {peak:.3f} GiB; |CUDA − CPU| logits "
            f"{err:.3e} of {scale:.3e}")
        del model, cpu_model, xd, logits, grad
        torch.cuda.empty_cache()
    log(f"[zoo] {json.dumps(out)}")
    return out


def _all_counts():
    from nerfail_tpu_torch.ops.cuda.knn_kernel import knn_sq_cuda
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import mlp_backward, mlp_forward
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        segment_sq, segment_sum,
    )

    return {"K1": segment_sum.launches, "K2": segment_sq.launches,
            "K3": knn_sq_cuda.launches,
            "K3 merge": knn_sq_cuda.merge_launches,
            "K4": mlp_forward.launches, "K5": mlp_backward.launches}


def _zero_all():
    from nerfail_tpu_torch.ops.cuda.knn_kernel import knn_sq_cuda
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import mlp_backward, mlp_forward
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        segment_sq, segment_sum,
    )

    for fn in (segment_sum, segment_sq, knn_sq_cuda, mlp_forward,
               mlp_backward):
        fn.launches = 0
    knn_sq_cuda.merge_launches = 0


def png_codec_times(path, img):
    """Host wall ms of utils/png writing and reading one image (best of 3)
    and whether the read equals the image."""
    from nerfail_tpu_torch.utils.png import imread, imwrite

    w, r = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        imwrite(path, img)
        t1 = time.perf_counter()
        back = imread(path)
        r.append(time.perf_counter() - t1)
        w.append(t1 - t0)
    return min(w) * 1e3, min(r) * 1e3, bool((back == img).all())


def pipeline_attack_phase(dev, ori, mp):
    """The four engines through Pipeline.stage_attack, as a user runs
    them: the main path's 16 views at 800², its 3·800²-point tables and
    the trained Inception-V3 (ε 32, a 2, batch and view batch 8, m2 1000,
    DeepFool ≤ 50 iterations), save and checkpoint on, then stage_eval on
    each result. Every kernel counter is set to 0 just before each engine
    and read just after it."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nerfail_tpu_torch.config import (
        SCENE_CLASSES, AttackConfig, ExperimentConfig,
    )
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline
    from nerfail_tpu_torch.utils.png import imread

    scene_name = SCENE_CLASSES[0]       # the attacked scene is class 0
    tables = (mp["weights"], mp["idx"])
    out = {}
    with tempfile.TemporaryDirectory() as root:
        pipe = Pipeline(ArtifactLayout(root), ExperimentConfig(), device=dev)
        for method, epochs in PIPE_EPOCHS.items():
            acfg = AttackConfig(method=method, eps=EPS, a=STEP_A, m2=DF_M2,
                                df_max_iter=DF_MAX_ITER, batch_size=BATCH,
                                view_batch=BATCH, attack_epochs=epochs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_all()
            t0 = time.time()
            res = pipe.stage_attack(
                method, acfg, scene_name, "inception", mp["logits_fn"],
                RESIZE, ori, tables=tables,
                mask_images=ori[list(MASK_VIEWS)], epochs=epochs)
            torch.cuda.synchronize()
            wall = time.time() - t0
            for m in res.history:
                log(f"[pipeline] {method} epoch {m['epoch']}: "
                    f"{json.dumps(m)}")
            launches = _all_counts()
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            attacked, _ = pipe.render_attacked(
                method, res.delta, ori, tables, acfg, RESIZE,
                mp["logits_fn"])
            report = pipe.stage_eval(mp["logits_fn"], attacked, ori,
                                     scene_name, resize_to=RESIZE)
            lay = pipe.layout
            method_dir = lay.attack_dir("inception", scene_name, method,
                                        acfg)
            test_dir = os.path.join(method_dir, "test")
            back = imread(os.path.join(test_dir, "r_0.png"))
            view0 = np.clip(attacked[0], 0, 255).astype(np.uint8)
            names = sorted(os.listdir(test_dir))
            row = {"wall_s": wall, "epoch_s": res.history[0]["time_s"],
                   "epochs_run": len(res.history), "asr": report["asr"],
                   "clean_acc": report["clean_acc_target_class"],
                   "e_max": report["e_max"], "psnr_avg": report["psnr_avg"],
                   "peak_gb": peak, "launches": launches}
            out[method] = row
            log(f"[pipeline] {method} at {H}², {N_VIEWS} views, {epochs} "
                f"epoch(s): wall {wall:.3f} s, first epoch "
                f"{row['epoch_s']:.3f} s, ASR {report['asr']:.4f}, clean "
                f"accuracy {row['clean_acc']:.4f}, e_max "
                f"{report['e_max']:.4f}, peak {peak:.3f} GiB; launches "
                f"{json.dumps(launches)}; {len(names)} files in "
                f"{os.path.relpath(test_dir, root)}")
            require(report["e_max"] <= EPS + 1e-3, f"{method}: e_max ≤ ε")
            require(back.shape == view0.shape and bool((back == view0).all()),
                    f"{method}: r_0.png reads back as the clipped uint8 view")
            require(len([n for n in names if not n.endswith("_ori.png")])
                    == N_VIEWS, f"{method}: one r_<i>.png a view")
            require(not os.path.exists(os.path.join(method_dir,
                                                    "attack_state.npz")),
                    f"{method}: attack_state.npz removed at the end")
            require(os.path.exists(os.path.join(
                method_dir, "universal.npy" if method == "Universal_2D"
                else "delta.npy")), f"{method}: perturbation saved")
            if method in ("NeRFail_S", "NeRFail"):
                require(launches["K1"] > 0, f"{method} launched K1")
            if method == "NeRFail":
                require(launches["K2"] > 0, "NeRFail launched K2")
            if method in ("IGSM_2D", "Universal_2D"):
                require(not any(launches.values()),
                        f"{method} launches no kernel of the port")
        w_ms, r_ms, same = png_codec_times(
            os.path.join(root, "codec.png"),
            np.clip(attacked[0], 0, 255).astype(np.uint8))
        require(same, "PNG codec round trip")
    out["png_ms"] = {"write": w_ms, "read": r_ms}
    log(f"[pipeline] utils/png, one {H}² RGBA image, host wall best of 3: "
        f"write {w_ms:.3f} ms, read {r_ms:.3f} ms")
    return out


def cli_phase(dev, model):
    """The reference's experiment through `nerfail_tpu_torch.cli.main`,
    in process, on a box scene (class 0) written by write_blender_format:
    CLI_VIEWS train/val/test views at CLI_H², the full-width NeRF
    (8×256, 64 + 128 samples, 1024 rays) from a config file; the 8-class
    root of train-classifier at CLI_CLASS_H²; the attack against the
    trained Inception-V3 saved where the layout names it. Every counter is
    set to 0 before each command and read after it; each artifact the
    reference's grammar names must exist."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from nerfail_tpu_torch.cli import main as cli
    from nerfail_tpu_torch.config import SCENE_CLASSES, AttackConfig
    from nerfail_tpu_torch.data.synthetic import (
        make_box_scene, write_blender_format,
    )
    from nerfail_tpu_torch.pipeline import ArtifactLayout
    from nerfail_tpu_torch.train.checkpoint import save_checkpoint
    from nerfail_tpu_torch.utils.png import imread

    label = SCENE_CLASSES[0]
    n_train, n_val, n_test = CLI_VIEWS
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        write_blender_format(make_box_scene(
            n_train=n_train, n_val=n_val, n_test=n_test, H=CLI_H, W=CLI_H,
            seed=SEED), os.path.join(root, label))
        for ci, cls in enumerate(SCENE_CLASSES):
            write_blender_format(make_box_scene(
                n_train=8, n_val=2, n_test=0, H=CLI_CLASS_H, W=CLI_CLASS_H,
                seed=ci, variant=ci), os.path.join(root, "classes", cls))
        cfg_path = os.path.join(root, "chair.txt")
        with open(cfg_path, "w") as f:
            f.write(f"expname = {label}\ndatadir = {root}/{label}\n"
                    "dataset_type = blender\ntestskip = 1\n"
                    "N_samples = 64\nN_importance = 128\nN_rand = 1024\n"
                    "precrop_iters = 10\ni_print = 1000000\n"
                    "i_weights = 1000000\n")
        out_dir = os.path.join(root, "out")
        lay = ArtifactLayout(out_dir)
        save_checkpoint(lay.classifier_best("inception"),
                        {"model": model.state_dict()})
        log(f"[cli] box scene {n_train} + {n_val} + {n_test} views at "
            f"{CLI_H}² and the 8-class root written: "
            f"{time.time() - t0:.3f} s")
        com = ["--config", cfg_path, "--output", out_dir, "--device",
               str(dev)]
        atk = ["--method", "NeRFail_S", "--label", label, "--model_name",
               "inception", "--attack_epochs", "1"]
        mask = os.path.join(root, label, "test", "r_0.png")
        commands = [
            ("train-nerf", [*com, "--n_iters", str(CLI_NERF_STEPS)]),
            ("extract-coords", com),
            ("render-only", com),
            ("invert-disturbance", ["--input", mask, "--out",
                                    os.path.join(root, "inverted.png")]),
            ("train-classifier", [*com, "--model_name", "simple_cnn",
                                  "--datadir", os.path.join(root, "classes"),
                                  "--epochs", str(CLI_CLS_EPOCHS),
                                  "--batch_size", "16"]),
            ("attack", [*com, *atk]),
            ("evaluate", [*com, *atk, "--step", "0"]),
            ("inherit", [*com, *atk, "--render_factor", "2", "--n_iters",
                         str(CLI_INHERIT_STEPS)]),
        ]
        for name, argv in commands:
            buf = io.StringIO()
            torch.cuda.synchronize()
            _zero_all()
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                cli([name, *argv])
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = _all_counts()
            out[name] = {"wall_s": wall, "launches": launches}
            text = buf.getvalue().strip().splitlines()
            log(f"[cli] {name}: {wall:.3f} s, launches "
                f"{json.dumps(launches)}; last output line: "
                f"{text[-1] if text else ''}")

        n_all = n_train + n_val + n_test
        acfg = AttackConfig(method="NeRFail_S", attack_epochs=1)
        step0 = lay.attack_dir("inception", label, "NeRFail_S", acfg)
        step1 = lay.attack_dir("inception", label, "NeRFail_S", acfg, step=1)
        tag = "inception_" + lay.attack_method_dirname("NeRFail_S", acfg)
        expect = [
            os.path.join(lay.nerf_logdir(label), f"{CLI_NERF_STEPS:06d}.ckpt"),
            os.path.join(lay.coords_dir(label), "coords.npz"),
            os.path.join(root, "inverted.png"),
            lay.classifier_best("simple_cnn"),
            os.path.join(step0, "delta.npy"),
            lay.eval_report_path(step0, "test"),
            os.path.join(lay.nerf_logdir(label, tag),
                         f"{CLI_INHERIT_STEPS:06d}.ckpt"),
            lay.eval_report_path(step1, "test"),
        ] + [lay.tables_path(label, 3, s) for s in ("train", "val", "test")]
        missing = [p for p in expect if not os.path.exists(p)]
        counts = {
            "renderonly": [len(os.listdir(os.path.join(
                out_dir, "renders", label,
                f"renderonly_{s}_{CLI_NERF_STEPS - 1:06d}"))) for s in
                ("train", "val", "test")],
            "attack test": len(os.listdir(os.path.join(step0, "test"))),
            "attack masks": len(os.listdir(lay.attack_masks_dir(step0,
                                                                "test"))),
            "inherit train": len(os.listdir(os.path.join(step0, "train"))),
            "step 1": [len(os.listdir(os.path.join(step1, s)))
                       for s in ("train", "val", "test")],
        }
        log(f"[cli] artifacts: {len(expect) - len(missing)} of "
            f"{len(expect)} named files exist; file counts "
            f"{json.dumps(counts)}")
        require(not missing, f"CLI artifacts exist (missing {missing})")
        require(counts["renderonly"] == [2 * n for n in CLI_VIEWS],
                "render-only: NNN.png and NNN.npy a view")
        require(counts["attack test"] == 2 * n_test
                and counts["attack masks"] == n_test,
                "attack: r_<i>.png, r_<i>_ori.png and a mask a test view")
        require(counts["inherit train"] == 2 * n_train,
                "inherit: attacked train views written")
        require(counts["step 1"] == list(CLI_VIEWS),
                "inherit: step-1 renders of every split")
        half = imread(os.path.join(step1, "test", "000.png"))
        require(half.shape == (CLI_H // 2, CLI_H // 2, 3),
                "inherit renders at render_factor 2")
        coords = np.load(os.path.join(lay.coords_dir(label), "coords.npz"))
        require(coords["coords"].shape == (n_all, CLI_H, CLI_H, 3)
                and bool(np.isfinite(coords["coords"]).all()),
                "extract-coords: finite coordinate maps of every view")
        with open(lay.eval_report_path(step0, "test")) as f:
            rep = json.load(f)
        out["attack_report"] = {k: rep[k] for k in (
            "asr", "clean_acc_target_class", "e_max")}
        log(f"[cli] attack report (NeRFail_S, 1 epoch, {n_test} views at "
            f"{CLI_H}²): {json.dumps(out['attack_report'])}")
        require(rep["e_max"] <= 32.0 + 1e-3, "CLI attack: e_max ≤ ε")
    c = {k: v["launches"] for k, v in out.items() if "launches" in v}
    require(c["train-nerf"]["K4"] == c["train-nerf"]["K5"]
            == 2 * CLI_NERF_STEPS, "train-nerf: K4 and K5 twice a step")
    require(c["extract-coords"]["K4"] > 0 and c["render-only"]["K4"] > 0,
            "the renders run K4")
    require(c["attack"]["K3"] == n_all and c["attack"]["K1"] > 0
            and c["attack"]["K4"] > 0,
            "attack: K4 coordinate maps, K3 a view, K1 a step")
    require(c["inherit"]["K5"] == 2 * CLI_INHERIT_STEPS
            and c["inherit"]["K4"] > 2 * CLI_INHERIT_STEPS,
            "inherit: K4/K5 retrain and K4 renders")
    return out


# ---- phase 12: [multi], the sharded paths in several ranks ------------------
#
# a + b run in 2 gloo ranks that share cuda:0 (gloo's collectives take CUDA
# tensors); c in an NCCL world of one rank per visible card (1 on a
# one-card machine). Their times are of ranks sharing a card, not a
# scaling result.

MULTI_RANKS = 2
MULTI_NCCL_MAX = 4
# the settings a rank needs from this module: spawned ranks import it
# afresh, so `multi_phase` hands them the parent's values
_RANK_CONSTS = ("SEED", "N_VIEWS", "N_CLASSES", "RESIZE", "EPS", "STEP_A",
                "BATCH", "EPOCHS", "DF_M2", "DF_MAX_ITER", "DF_EPOCHS",
                "NERF_H", "NERF_STEPS", "MULTI_K")


def _rank_setup(consts):
    import torch

    globals().update(consts)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _rank0_log(mesh, name):
    def log_fn(epoch, entry):
        if mesh.rank == 0:
            log(f"[multi] rank 0 of {mesh.size}, {name} epoch {epoch}: "
                f"{json.dumps(entry)}")
    return log_fn


def _deterministic():
    """cuDNN in deterministic algorithms: a NeRFail-S run then repeats bit
    for bit, so a sharded run is held to a single one by its own effect
    (the sum order of the gradient), not the convolutions' atomics."""
    import torch

    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_inputs(tmp, dev):
    """The main path's tables, views, δ0 and trained Inception-V3, from
    the files `multi_phase` wrote."""
    import os

    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import make_classifier_logits_fn
    from nerfail_tpu_torch.models.classifiers.inception_v3 import (
        InceptionV3,
    )

    arrays = {k: np.load(os.path.join(tmp, f"{k}.npy"), mmap_mode="r")
              for k in ("weights", "idx", "ori", "delta0")}
    model = InceptionV3(num_classes=N_CLASSES, aux_logits=True)
    model.load_state_dict(torch.load(os.path.join(tmp, "inception.pt"),
                                     map_location="cpu"))
    return arrays, make_classifier_logits_fn(model.to(dev))


def _rank_nerfail_s(mesh, arrays, logits_fn):
    """Phase 3a's NeRFail-S run on the mesh; its K1 launches on this
    rank."""
    import numpy as np

    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import segment_sum

    cfg = AttackConfig(method="NeRFail_S", eps=EPS, a=STEP_A,
                       batch_size=BATCH)
    _sync(mesh.device)
    segment_sum.launches = 0
    t0 = time.time()
    with _deterministic():
        res = nerfail_s_attack(
            np.array(arrays["delta0"]), arrays["weights"], arrays["idx"],
            arrays["ori"], np.zeros(N_VIEWS, np.int64), logits_fn, cfg,
            resize_to=RESIZE, epochs=EPOCHS, mesh=mesh,
            log_fn=_rank0_log(mesh, "NeRFail-S"))
    _sync(mesh.device)
    return {"delta": res.delta, "history": res.history,
            "wall_s": time.time() - t0, "k1": segment_sum.launches,
            "step_ms": res.history[-1]["time_s"] / -(-N_VIEWS // BATCH)
            * 1e3}


def _rank_nerfail(mesh, arrays, logits_fn):
    """Phase 3b's NeRFail run on the mesh; this rank's K1 / K2 launches."""
    import numpy as np

    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        segment_sq, segment_sum,
    )

    cfg = AttackConfig(method="NeRFail", eps=EPS, m2=DF_M2,
                       df_max_iter=DF_MAX_ITER, view_batch=BATCH)
    _sync(mesh.device)
    segment_sum.launches = segment_sq.launches = 0
    t0 = time.time()
    res = nerfail_attack(
        np.array(arrays["delta0"]), arrays["weights"], arrays["idx"],
        arrays["ori"], logits_fn, cfg, resize_to=RESIZE, epochs=DF_EPOCHS,
        mesh=mesh, log_fn=_rank0_log(mesh, "NeRFail"))
    _sync(mesh.device)
    return {"delta": res.delta, "history": res.history,
            "wall_s": time.time() - t0, "k1": segment_sum.launches,
            "k2": segment_sq.launches}


def _rank_train(mesh, tmp, cfg, model_parallel):
    """Phase 7's train_nerf (`cfg`: full width, 30 steps) on a (2 / mp, mp)
    mesh of the process group: losses, whole final parameters, this rank's
    K4 / K5 launches; then a captured window over gloo must raise."""
    import os

    import numpy as np

    from nerfail_tpu_torch.parallel.mesh import make_mesh
    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, make_multi_train_step, shard_train_state,
        train_nerf,
    )

    if mesh.shape["model"] != model_parallel:
        mesh = make_mesh(mesh.size, model_parallel, device=mesh.device)
    sc = np.load(os.path.join(tmp, "nerf_scene.npz"))
    steps = []
    _sync(mesh.device)
    _zero_counts()
    t0 = time.time()
    state = train_nerf(cfg, sc["targets"], sc["poses"], sc["K"],
                       sc["i_train"], n_iters=NERF_STEPS, mesh=mesh,
                       log_fn=lambda i, m: steps.append(m))
    _sync(mesh.device)
    wall = time.time() - t0
    k4, k5 = _counts()
    raised = None
    sharded = shard_train_state(mesh, create_train_state(
        SEED, cfg.model, cfg.render, cfg.train, mesh.device))
    multi = make_multi_train_step(cfg.model, cfg.render, cfg.train, False,
                                  2, mesh=mesh)
    if mesh.device.type == "cuda":
        try:
            multi(sharded, sc["targets"][sc["i_train"]],
                  sc["poses"][sc["i_train"]], sc["K"], SEED)
        except RuntimeError as e:
            raised = str(e)
    return {"losses": [m["loss"] for m in steps],
            "step_ms": [1e3 / m["steps_per_s"] for m in steps],
            "wall_s": wall, "k4": k4, "k5": k5, "gloo_capture": raised,
            "mesh": mesh.shape,
            "params": {n: {k: v.detach().cpu().numpy()
                           for k, v in state.params[n].items()}
                       for n in ("coarse", "fine")}}


def _multi_gloo_rank(mesh, tmp, consts, cfg):
    """Parts a and b in one rank: both attacks, then train_nerf on the
    (2, 1) and the (1, 2) mesh."""
    _rank_setup(consts)
    arrays, logits_fn = _rank_inputs(tmp, mesh.device)
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "nerfail_s": _rank_nerfail_s(mesh, arrays, logits_fn),
           "nerfail": _rank_nerfail(mesh, arrays, logits_fn)}
    del arrays, logits_fn
    for mp in (1, 2):
        out[f"train_mp{mp}"] = _rank_train(mesh, tmp, cfg, mp)
    return out


def _multi_nccl_rank(mesh, tmp, consts, cfg):
    """Part c in one rank of the NCCL world: phase 3a's NeRFail-S, then
    one make_multi_train_step window of MULTI_K steps (its all-reduce
    captured in the graph) against MULTI_K eager sharded steps of the
    same capturable Adam on the same draws."""
    import os

    import numpy as np
    import torch

    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, gather_train_state, make_capturable,
        make_multi_train_step, make_train_step, sample_rays,
        shard_train_state, step_seed,
    )

    _rank_setup(consts)
    arrays, logits_fn = _rank_inputs(tmp, mesh.device)
    out = {"rank": mesh.rank, "world": mesh.size, "backend": mesh.backend,
           "nerfail_s": _rank_nerfail_s(mesh, arrays, logits_fn)}
    del arrays, logits_fn
    dev = mesh.device
    sc = np.load(os.path.join(tmp, "nerf_scene.npz"))
    mcfg, rcfg = cfg.model, cfg.render
    tcfg = dataclasses.replace(cfg.train, precrop_iters=0)
    it = sc["i_train"]
    imgs, poses, K = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (sc["targets"][it], sc["poses"][it],
                                sc["K"]))
    hw, k = (NERF_H, NERF_H), MULTI_K
    ref = shard_train_state(mesh, create_train_state(SEED, mcfg, rcfg,
                                                     tcfg, dev))
    if dev.type == "cuda":
        make_capturable(ref.opt_state)
    step = make_train_step(mcfg, rcfg, tcfg, mesh=mesh)
    gen = torch.Generator(device=dev)
    _zero_counts()
    for i in range(k):
        gen.manual_seed(step_seed(SEED, i))
        batch = sample_rays(gen, imgs, poses, K, tcfg.N_rand, False,
                            tcfg.precrop_frac, tcfg.no_batching)
        m_ref = step(ref, batch, gen, hw, 0.0)
    _sync(dev)
    eager_k4, eager_k5 = _counts()
    state = shard_train_state(mesh, create_train_state(SEED, mcfg, rcfg,
                                                       tcfg, dev))
    multi = make_multi_train_step(mcfg, rcfg, tcfg, False, k, mesh=mesh)
    t0 = time.time()
    m = multi(state, imgs, poses, K, SEED)
    _sync(dev)
    first_s = time.time() - t0
    a = gather_train_state(mesh, state).params
    b = gather_train_state(mesh, ref).params
    diff = max(float((a[n][key] - b[n][key]).detach().abs().max())
               for n in ("coarse", "fine") for key in a[n])
    replay_ms = None
    if dev.type == "cuda":           # replays of further windows, timed
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(3):
            multi(state, imgs, poses, K, SEED)
        ev1.record()
        _sync(dev)
        replay_ms = ev0.elapsed_time(ev1) / (3 * k)
    out.update(window_max_abs_diff=diff,
               window_loss=float(m["loss"]), eager_loss=float(m_ref["loss"]),
               eager_k4=eager_k4, eager_k5=eager_k5, first_call_s=first_s,
               replay_step_ms=replay_ms)
    return out


def _same_history(a, b, keys):
    return [{k: h[k] for k in keys} for h in a] == \
        [{k: h[k] for k in keys} for h in b]


def _rgb_off(mp, a, b) -> float:
    """The fraction of δ's RGB entries under the mask alpha (the ones a
    step moves) where a and b differ."""
    import numpy as np

    alpha = np.asarray(mp["delta0"])[..., 3] > 0
    return float(np.mean(a[..., :3][alpha] != b[..., :3][alpha]))


def _sign_tie_rate(dev, mp, shards: int) -> float:
    """The fraction of δ0's moving RGB entries whose NeRFail-S gradient on
    batch 0 changes sign when the batch's views are summed in `shards`
    parts (each part's K1 sum, then their sum: the sharded step's order)
    instead of in one K1 pass: the sign ties a sharded run may step the
    other way."""
    import torch
    import torch.nn.functional as F

    from nerfail_tpu_torch.attacks.forward import splat_attack_forward
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import build_csr_plan

    d0 = torch.as_tensor(mp["delta0"], device=dev)
    M = d0.reshape(-1, 4).shape[0]

    def grad(lo, hi):
        w, i = mp["weights"][lo:hi], mp["idx"][lo:hi]
        o = mp["ori_d"][lo:hi].to(torch.float32)
        plan = build_csr_plan(i, w, M, pair_mask=o[..., 3:] > 0)
        d = d0.clone().requires_grad_(True)
        out = splat_attack_forward(d.reshape(-1, 4), w, i, o,
                                   mp["logits_fn"], eps=EPS,
                                   resize_to=RESIZE, plan=plan, device=dev)
        labels = torch.zeros(hi - lo, dtype=torch.int64, device=dev)
        ce = F.cross_entropy(out["logits"], labels, reduction="sum") / BATCH
        return torch.autograd.grad(ce, d)[0]

    with _deterministic():
        whole = grad(0, BATCH)
        per = BATCH // shards
        parts = grad(0, per)
        for r in range(1, shards):
            parts = parts + grad(r * per, (r + 1) * per)
    alpha = d0[..., 3] > 0
    a = torch.sign(whole[..., :3])[alpha]
    b = torch.sign(parts[..., :3])[alpha]
    return float((a != b).to(torch.float32).mean())


def _hold_attack(dev, mp, name, single, ranks, keys, check):
    """A sharded attack against a single-process run: histories and δ
    bit-equal across the ranks, the history equal to the single run's and
    the final ASR its; returns the fraction of δ's moving entries off the
    single run's, δ's relative L2 distance from it and the sharded δ's
    report."""
    import numpy as np

    r0 = ranks[0]
    for r in ranks[1:]:
        check(np.array_equal(r["delta"], r0["delta"]),
              f"{name}: δ bit-equal across the ranks")
        check(_same_history(r["history"], r0["history"], keys),
              f"{name}: the same history on every rank")
    check(_same_history(r0["history"], single["res"].history, keys),
          f"{name}: history {keys} equal to the single run's")
    _, rep = attack_report(dev, mp, r0["delta"], f"{name} (sharded)")
    check(rep["asr"] == single["report"]["asr"],
          f"{name}: final ASR equal to the single run's")
    d = r0["delta"][..., :3] - single["res"].delta[..., :3]
    rel = float(np.linalg.norm(d) / max(np.linalg.norm(
        single["res"].delta[..., :3]), 1e-30))
    return _rgb_off(mp, r0["delta"], single["res"].delta), rel, rep


def _single_nerfail_s(dev, mp):
    """Phase 3a's NeRFail-S once more in this process, in deterministic
    cuDNN: phase 12's reference."""
    import numpy as np

    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig

    cfg = AttackConfig(method="NeRFail_S", eps=EPS, a=STEP_A,
                       batch_size=BATCH)
    with _deterministic():
        res = nerfail_s_attack(
            mp["delta0"], mp["weights"], mp["idx"], mp["ori_d"],
            np.zeros(N_VIEWS, np.int64), mp["logits_fn"], cfg,
            resize_to=RESIZE, epochs=EPOCHS, device=dev)
    _, rep = attack_report(dev, mp, res.delta, "NeRFail-S (reference)")
    return {"res": res, "report": rep}


def multi_phase(dev, mp, df, nt, model, device_type="cuda",
                nccl_backend="nccl"):
    """Phase 12: the sharded paths (parallel/) in several ranks.
    `device_type` / `nccl_backend` other than the card's and NCCL are for
    a rehearsal on the CPU."""
    import os
    import tempfile

    import numpy as np
    import torch

    from nerfail_tpu_torch.parallel.launch import spawn

    out, fails = {}, []

    def check(cond, what: str) -> None:
        # every check of the phase is logged; the phase fails at its end
        # if any did
        log(f"[multi] {'ok' if cond else 'FAILED'}: {what}")
        if not cond:
            fails.append(what)

    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        for k in ("weights", "idx"):
            np.save(os.path.join(tmp, f"{k}.npy"), mp[k].cpu().numpy())
        np.save(os.path.join(tmp, "ori.npy"), mp["ori_d"].cpu().numpy())
        np.save(os.path.join(tmp, "delta0.npy"), mp["delta0"])
        torch.save(model.state_dict(),
                   os.path.join(tmp, "inception.pt"))
        sc = nt["scene"]
        np.savez(os.path.join(tmp, "nerf_scene.npz"), targets=nt["targets"],
                 poses=sc.poses, K=sc.K, i_train=sc.i_train)
        log(f"[multi] inputs written for the ranks: "
            f"{time.time() - t0:.3f} s")
        consts = {k: globals()[k] for k in _RANK_CONSTS}
        args = (tmp, consts, nt["cfg"])

        # a + b: 2 gloo ranks sharing cuda:0
        t0 = time.time()
        ranks = spawn(_multi_gloo_rank, MULTI_RANKS, backend="gloo",
                      device_type=device_type, model_parallel=1, args=args)
        out["gloo_wall_s"] = time.time() - t0
        log(f"[multi] 2 gloo ranks sharing one card ({card}): "
            f"{out['gloo_wall_s']:.3f} s, devices "
            f"{[r['device'] for r in ranks]}")
        s_keys = ("epoch", "attack_acc", "clean_acc")
        ref_s = _single_nerfail_s(dev, mp)
        check(_same_history(ref_s["res"].history, mp["res"].history,
                            s_keys),
              "NeRFail-S reference (deterministic cuDNN): phase 3a's "
              "history")
        off, rel, rep = _hold_attack(dev, mp, "NeRFail-S", ref_s,
                                     [r["nerfail_s"] for r in ranks],
                                     s_keys, check)
        n_steps = EPOCHS * -(-N_VIEWS // BATCH)
        tie = _sign_tie_rate(dev, mp, MULTI_RANKS)
        k1 = [r["nerfail_s"]["k1"] for r in ranks]
        out["nerfail_s"] = {
            "k1_per_rank": k1, "sign_tie_rate_one_step": tie,
            # cuDNN's own atomics: phase 3a's run against the reference
            "phase3a_rgb_off_reference": _rgb_off(
                mp, mp["res"].delta, ref_s["res"].delta),
            "delta_rgb_off_single": off, "delta_rel_l2_single": rel,
            "asr": rep["asr"], "single_asr": ref_s["report"]["asr"],
            "wall_s": [r["nerfail_s"]["wall_s"] for r in ranks],
            "step_ms": [r["nerfail_s"]["step_ms"] for r in ranks]}
        log(f"[multi] NeRFail-S on (2, 1), 2 ranks sharing one card: "
            f"{json.dumps(out['nerfail_s'])}")
        check(all(c == n_steps for c in k1),
              f"NeRFail-S: K1 once per batch on every rank ({n_steps})")
        check(tie <= 0.01,
              f"NeRFail-S: one sign step over the ranks' sum order flips at "
              f"most 1 % of δ's moving entries ({tie:.6f})")

        n_keys = ("epoch", "m1", "m2", "attack_acc", "deepfool_calls")
        off, rel, rep = _hold_attack(dev, mp, "NeRFail", df,
                                     [r["nerfail"] for r in ranks], n_keys,
                                     check)
        per = BATCH // MULTI_RANKS
        want = [sum(max(min(i + 1, DF_MAX_ITER) for i in b[r * per:
                                                          (r + 1) * per])
                    for h in ranks[0]["nerfail"]["history"]
                    for b in h["deepfool_iters"])
                for r in range(MULTI_RANKS)]
        got = [(r["nerfail"]["k1"], r["nerfail"]["k2"]) for r in ranks]
        out["nerfail"] = {
            "k1_k2_per_rank": got, "expected_per_rank": want,
            "delta_rel_l2_single": rel, "asr": rep["asr"],
            "single_asr": df["report"]["asr"],
            "wall_s": [r["nerfail"]["wall_s"] for r in ranks]}
        log(f"[multi] NeRFail on (2, 1), 2 ranks sharing one card: "
            f"{json.dumps(out['nerfail'])}")
        check(all(a == b == w for (a, b), w in zip(got, want)),
              "NeRFail: K2 and the K1 pick once per DeepFool iteration of "
              "the rank's views")

        ref_losses = np.asarray(nt["losses"])
        for mpar in (1, 2):
            tr = [r[f"train_mp{mpar}"] for r in ranks]
            name = f"train_nerf on {tuple(tr[0]['mesh'].values())}"
            rel = np.abs(np.asarray(tr[0]["losses"]) - ref_losses) / \
                ref_losses
            d = np.concatenate([
                np.abs(tr[0]["params"][n][k] - nt["final"][n][k]).ravel()
                for n in nt["final"] for k in nt["final"][n]])
            out[f"train_mp{mpar}"] = {
                "k4_k5_per_rank": [(r["k4"], r["k5"]) for r in tr],
                "loss_rel_max": float(rel.max()),
                "param_max_abs": float(d.max()),
                "param_frac_over_1e-4": float(np.mean(d > 1e-4)),
                "wall_s": [r["wall_s"] for r in tr],
                "steady_step_ms": [float(np.median(r["step_ms"][10:]))
                                   for r in tr]}
            log(f"[multi] {name}, 2 ranks sharing one card: "
                f"{json.dumps(out[f'train_mp{mpar}'])}; gloo capture: "
                f"{tr[0]['gloo_capture']}")
            check(all(np.array_equal(r["params"][n][k],
                                     tr[0]["params"][n][k])
                      for r in tr[1:] for n in r["params"]
                      for k in r["params"][n]),
                  f"{name}: parameters equal on every rank")
            check(float(rel.max()) <= 1e-3,
                  f"{name}: loss history within 0.1 % of the single run's "
                  f"at every step")
            check(float(d.max()) <= 2 * nt["cfg"].train.lrate * NERF_STEPS,
                  f"{name}: no final parameter farther from the single "
                  f"run's than 2·lr a step (Adam's step is ≤ lr in size)")
            check(all(r["k4"] == r["k5"] == 2 * NERF_STEPS for r in tr),
                  f"{name}: K4 and K5 twice per step per rank")
            check(device_type != "cuda"
                  or all(r["gloo_capture"] for r in tr),
                  f"{name}: a captured window over gloo raises")

        # c: NCCL, one rank per visible card
        world = (min(torch.cuda.device_count(), MULTI_NCCL_MAX)
                 if device_type == "cuda" else 1)
        t0 = time.time()
        nccl = spawn(_multi_nccl_rank, world, backend=nccl_backend,
                     device_type=device_type, args=args)
        out["nccl_wall_s"] = time.time() - t0
    off, rel, rep = _hold_attack(dev, mp, "NeRFail-S (NCCL)", ref_s,
                                 [r["nerfail_s"] for r in nccl], s_keys,
                                 check)
    out["nccl"] = {
        "world": world, "delta_rgb_off_single": off,
        "delta_rel_l2_single": rel, "asr": rep["asr"],
        "k1_per_rank": [r["nerfail_s"]["k1"] for r in nccl],
        "window_max_abs_diff": [r["window_max_abs_diff"] for r in nccl],
        "window_loss": nccl[0]["window_loss"],
        "eager_k4_k5": [(r["eager_k4"], r["eager_k5"]) for r in nccl],
        "replay_step_ms": [r["replay_step_ms"] for r in nccl],
        "first_call_s": [r["first_call_s"] for r in nccl],
        "wall_s": out["nccl_wall_s"]}
    log(f"[multi] NCCL world of {world} rank(s), one per card ({card}): "
        f"{json.dumps(out['nccl'])}")
    check(all(r["backend"] == nccl_backend and r["world"] == world
              for r in nccl), "an NCCL world of every visible card")
    check(world > 1 or off == 0.0,
          "NeRFail-S over an NCCL world of one rank: δ bit-equal to the "
          "single run's (the same sums)")
    check(all(r["window_max_abs_diff"] == 0.0 for r in nccl),
          f"the captured window (NCCL all-reduce in the graph) bit-equal "
          f"to {MULTI_K} eager sharded steps")
    check(all(r["eager_k4"] == r["eager_k5"] == 2 * MULTI_K
              for r in nccl), "NCCL eager sharded steps through K4/K5")
    require(not fails, "[multi] " + "; ".join(fails))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from nerfail_tpu_torch.ops.cuda import build
        from nerfail_tpu_torch.ops.cuda.knn_kernel import knn_sq_cuda
        from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
            segment_sq, segment_sum,
        )
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.time()
    logs = build.build_all()
    log(f"[build] {sorted(logs)} in {time.time() - t0:.3f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                log(f"[build] {name}: {line.strip()}")
    k4_ptxas = ptxas_counts(logs.get("nerf_mlp", ""), "mlp_fwd_ws_kernel")

    walls = {}
    t0 = time.time()
    model, cls = inception_phase(dev)
    walls["inception"] = time.time() - t0
    t0 = time.time()
    K, poses = scene(N_VIEWS, H)
    ori, S = views(K, poses, H)
    require(S.shape[0] == len(MASK_VIEWS) * H * H, "M = 3·800²")
    log(f"[scene] {N_VIEWS} views at {H}², M = {S.shape[0]}: "
        f"{time.time() - t0:.3f} s")

    t0 = time.time()
    segment_sum.launches = 0
    knn_sq_cuda.launches = 0
    knn_sq_cuda.merge_launches = 0
    mp = main_path(dev, K, poses, ori, S, model)
    launches = {"K1": segment_sum.launches, "K3": knn_sq_cuda.launches,
                "K3 merge": knn_sq_cuda.merge_launches}
    log(f"[main path] kernel launches: {launches}")
    n_steps = EPOCHS * -(-N_VIEWS // BATCH)
    require(launches["K1"] == n_steps, f"K1 once per step ({n_steps})")
    require(launches["K3"] == N_VIEWS, f"K3 search once per view ({N_VIEWS})")
    require(0 < launches["K3 merge"] <= N_VIEWS,
            "K3 merge at most once per view, and in some view")
    walls["nerfail_s_path"] = time.time() - t0

    t0 = time.time()
    segment_sum.launches = 0
    segment_sq.launches = 0
    df = nerfail_path(dev, mp)
    df_launches = {"K1": segment_sum.launches, "K2": segment_sq.launches}
    log(f"[nerfail path] kernel launches: {df_launches}, DeepFool "
        f"iterations {df['loops']}")
    require(df_launches["K2"] == df["loops"],
            "K2 once per DeepFool iteration, as the per-view iterations imply")
    require(df_launches["K1"] == df["loops"],
            "K1 (pick) once per DeepFool iteration")
    _, df["report"] = attack_report(dev, mp, df["res"].delta, "NeRFail")
    require(df["flipped"] > 0 and df["report"]["asr"] > 0,
            "DeepFool flipped at least one view, and the attack keeps one")
    walls["nerfail_path"] = time.time() - t0
    log(f"[walls] new phases, host clock: {json.dumps(walls)}")

    check_outputs(mp, S)
    small_cuda_vs_cpu(dev)
    small_nerfail_cuda_vs_cpu(dev)
    quality = quality_phase(dev)
    M = S.shape[0]
    k1 = k1_phase(dev, mp, M)
    k2, pick = k2_phase(dev, mp, df, M)
    k3 = k3_phase(dev, mp, K, poses, S)
    profile_step(dev, mp, M)
    dfp = profile_deepfool(dev, mp, df, M)
    # the NeRF path: each part with the K4/K5 counters set to 0 just
    # before it and read just after (inside the phase functions)
    nt = nerf_train_path(dev)
    # phase 12 holds the sharded train_nerf to these (later phases step
    # the state on)
    nt["final"] = {n: {k: v.detach().cpu().numpy()
                       for k, v in nt["state"].params[n].items()}
                   for n in ("coarse", "fine")}
    k45 = k45_phase(dev)
    nr = nerf_render_path(dev, nt, k45["K4"]["ms"])
    nq = nerf_quality(dev)
    cvc = nerf_cuda_vs_cpu(dev)
    npf = profile_nerf_step(dev, nt)
    t0 = time.time()
    msp = multi_step_phase(dev, nt)
    walls["multi_step"] = time.time() - t0
    t0 = time.time()
    zoo = zoo_phase(dev)
    walls["zoo"] = time.time() - t0
    log(f"[summary] classifier zoo: {len(zoo)} registry entries forward "
        f"and backward on the card, CUDA logits within 1e-3 of the CPU's, "
        f"in {walls['zoo']:.3f} s")
    t0 = time.time()
    imp = import_phase(dev)
    ann = annotate_phase(dev, ori, mp)
    walls["import_annotate"] = time.time() - t0
    log(f"[summary] multi-step (k = {msp['k']}, captured as one CUDA graph): "
        f"{msp['graph_ms']:.4f} ms a step replayed against "
        f"{msp['eager_ms']:.4f} ms eager (CUDA events), idle share of a "
        f"replay {msp['idle_share']}, bit-equal to the eager loop; "
        f"importer: InceptionResNetV2 logits within 2e-3 of the reference's "
        f"(max |Δ| {imp['max_abs_err']:.3e}); annotate: {len(ann['files'])} "
        f"800² views written")
    log(f"[summary] NeRF path: steady train step {nt['steady_ms']:.3f} ms "
        f"(profiled step: device {npf['device_ms']:.3f} of "
        f"{npf['wall_ms']:.3f} ms), {nr['size']}² render "
        f"{nr['render_s']:.3f} s, peak {nt['peak_gb']:.3f} GiB training, "
        f"{nr['peak_gb']:.3f} GiB rendering; 64² quality: PSNR "
        f"{nq['psnr']:.4f} dB, pts_max median {nq['median']:.5f}; 16² "
        f"CUDA-vs-CPU loss difference ≤ {cvc:.3e}")
    for name, rep in (("NeRFail-S", mp["report"]),
                      ("NeRFail", df["report"])):
        log(f"[summary] {name} at {H}² against the trained Inception-V3 "
            f"({N_VIEWS} views): ASR {rep['asr']:.4f}, clean accuracy "
            f"{rep['clean_acc_target_class']:.4f}, e_max {rep['e_max']:.4f} "
            f"≤ ε {EPS}, PSNR mean {rep['psnr_avg']:.4f} dB")
    log(f"[summary] Inception-V3: val_acc {cls['val_acc']:.4f}, trained in "
        f"{cls['train_s']:.3f} s (data {cls['data_s']:.3f} s)")
    log(f"[summary] NeRFail path (m1 {df['cfg'].m1}, m2 {DF_M2}, ≤ "
        f"{DF_MAX_ITER} iterations, {len(df['res'].history)} epochs run): "
        f"{df['loops']} "
        f"DeepFool iterations in {df['wall_s']:.3f} s, "
        f"{dfp['iter_ms']:.3f} ms per iteration (batch 0 walk), peak "
        f"{df['peak_gb']:.3f} GiB; quality (64² / SimpleCNN): val_acc "
        f"{quality['val_acc']:.4f}, NeRFail ASR {quality['NeRFail']['asr']}, "
        f"NeRFail-S ASR {quality['NeRFail-S']['asr']}")
    # the slice-10 phases: the four engines through Pipeline, then the CLI
    t0 = time.time()
    pipe = pipeline_attack_phase(dev, ori, mp)
    walls["pipeline_attack"] = time.time() - t0
    t0 = time.time()
    clip = cli_phase(dev, model)
    walls["cli"] = time.time() - t0
    log(f"[summary] pipeline phase {walls['pipeline_attack']:.3f} s, CLI "
        f"phase {walls['cli']:.3f} s: " + json.dumps(
            {m: {k: pipe[m][k] for k in ("wall_s", "asr", "e_max")}
             for m in PIPE_EPOCHS}))
    # the slice-12 phase: the sharded paths in several ranks
    t0 = time.time()
    mph = multi_phase(dev, mp, df, nt, model)
    walls["multi"] = time.time() - t0
    log(f"[summary] multi phase {walls['multi']:.3f} s: gloo ranks "
        f"sharing one card {mph['gloo_wall_s']:.3f} s, NCCL world of "
        f"{mph['nccl']['world']} {mph['nccl_wall_s']:.3f} s ({card_line()})")
    log(f"[walls] host clock: {json.dumps(walls)}")

    def new_phases(k):
        return {"pipeline_launches": {m: pipe[m]["launches"][k]
                                      for m in PIPE_EPOCHS},
                "cli_launches": {c: v["launches"][k]
                                 for c, v in clip.items() if "launches" in v}}

    rows = [
        {"name": "K1 splat-backward segmented sum", "route": "cuda",
         "source": "nerfail_tpu_torch/csrc/segsum.cu",
         "replaces": "nerfail_tpu/ops/pallas/segsum_kernel.py:395",
         "launches": launches["K1"], "nerfail_launches": df_launches["K1"],
         "multi_launches_per_rank": {
             "nerfail_s": mph["nerfail_s"]["k1_per_rank"],
             "nerfail": [a for a, _ in mph["nerfail"]["k1_k2_per_rank"]],
             "nccl_nerfail_s": mph["nccl"]["k1_per_rank"]},
         **k1, **pick, "engine_pick_ms": dfp["pick_ms"],
         "engine_pick_class_copy_ms": dfp["pick_class_copy_ms"],
         **new_phases("K1")},
        {"name": "K2 squared norms of the segmented sum", "route": "cuda",
         "source": "nerfail_tpu_torch/csrc/segsum_sq.cu",
         "replaces": "nerfail_tpu/ops/pallas/segsum_kernel.py:436",
         "launches": df_launches["K2"],
         "multi_launches_per_rank": {
             "nerfail": [b for _, b in mph["nerfail"]["k1_k2_per_rank"]]},
         **k2, **new_phases("K2")},
        {"name": "K3 exact 8-NN (split search + stable merge)",
         "route": "cuda", "source": "nerfail_tpu_torch/csrc/knn.cu",
         "parts": ["knn_search_kernel (one block per work item of at most "
                   f"{k3['item_tiles']} candidate tiles)",
                   "knn_merge_kernel (split rows' partial top-8s, stably "
                   "in item order)"],
         "replaces": "nerfail_tpu/ops/pallas/knn_kernel.py:44",
         "launches": launches["K3"], "merge_launches": launches["K3 merge"],
         **k3, **new_phases("K3")},
        {"name": "K4 fused NeRF encoding + MLP forward", "route": "cuda",
         "source": "nerfail_tpu_torch/csrc/nerf_mlp.cu",
         "replaces": "nerfail_tpu/ops/pallas/mlp_kernel.py:192",
         "launches": nt["k4"], "render_launches": nr["k4"],
         "multi_step_launches": msp["k4"],
         "graph_launches_per_replay": msp["graph_k4"],
         "multi_launches_per_rank": {
             f"train_mp{m}": [a for a, _ in mph[f"train_mp{m}"][
                 "k4_k5_per_rank"]] for m in (1, 2)},
         "ptxas": {f"W={w}": {"registers": r, "spill_stores": a,
                              "spill_loads": b}
                   for w, (r, a, b) in sorted(k4_ptxas.items())},
         **k45["K4"], **new_phases("K4")},
        {"name": "K5 fused NeRF MLP backward (recompute)", "route": "cuda",
         "source": "nerfail_tpu_torch/csrc/nerf_mlp.cu",
         "parts": ["mlp_bwd_pass_kernel (K5a: recompute, backward, stash, "
                   "db)", "mlp_wgrad_kernel (K5b: dW GEMM from the stash)",
                   "reduce_parts_kernel (fixed-order split sums)"],
         "replaces": "nerfail_tpu/ops/pallas/mlp_kernel.py:216",
         "launches": nt["k5"], "render_launches": 0,
         "multi_step_launches": msp["k5"],
         "graph_launches_per_replay": msp["graph_k5"],
         "multi_launches_per_rank": {
             f"train_mp{m}": [b for _, b in mph[f"train_mp{m}"][
                 "k4_k5_per_rank"]] for m in (1, 2)},
         "profiled_step_ms": npf["k5_ms"], **k45["K5"],
         **new_phases("K5")},
    ]
    log(json.dumps({"kernels": rows}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
