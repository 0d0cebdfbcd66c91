#!/usr/bin/env python3
"""Full-width check of the PyTorch/CUDA port (nerfail_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of the repository. It needs one CUDA device and nvcc,
and exits non-zero without a result line when either is missing. It
drives the main paths at the paper's width, where `tests/test_torch_gpu.py`
holds the kernels at small shapes and `benchmark/` times the cells:

1. builds the CUDA kernels from nerfail_tpu_torch/csrc;
2. trains Inception-V3 on the 8 box classes rendered at 800² and resized
   to 299² by the attack's own resize (eval/asr_800.py): the target;
3. 16 views of the box scene (class 0) at 800², a point set of 3·800² =
   1.92 M points from 3 mask views, the 8-NN tables by K3 and their
   Gaussian weights; the trained Inception-V3's clean accuracy on the 16
   views must be ≥ 0.8. Each attack runs with its kernels' launch
   counters set to 0 just before and read just after:
   a. NeRFail-S (ε = 32, a = 2, batch 8, 2 epochs: K1 once a step, K3
      and at most one merge a view);
   b. NeRFail on the same tables (m1 = 8, m2 = 1000, view batch 8,
      DeepFool ≤ 50 iterations, 3 epochs): K2 and the K1 pick once per
      DeepFool iteration that the history's per-view iterations imply;
      at least one view flips;
   evaluate_attack and evaluate_testset on each result (same ASR, e_max
   ≤ ε), and δ's shape, ε-ball, step grid and alpha, the tables' ranges
   and a mask view's self-distance 0;
4. holds each kernel against its plain PyTorch version on those paths'
   inputs: K1 on a NeRFail-S step's cotangent, the K1 pick and K2 on a
   DeepFool iteration's [8·800², 32] Gdiff stack, K3 on 64 K queries of a
   view against all 1.92 M points and on the whole view (the split search
   bit-equal to one work item a row);
5. the NeRF path at full width: train_nerf for 30 steps on the 800² box
   scene (8×256, 1024 rays of 64 + 128 samples; K4 and K5 twice a step),
   K4 and K5 against their plain versions at a step's 262 144 points,
   then extract_coord_maps for one view (K4 twice a chunk).

Its last lines are one JSON object {"kernels": [...]} (each kernel's
time by CUDA events, its plain version's, a library call's where one
exists, and its bound from the card's peaks), the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
# NeRFail as the TPU's 800² run: the reference's m1 = 8 (AttackConfig's
# default), m2 = 1000, DeepFool cap 50; 3 epochs
DF_M2, DF_MAX_ITER, DF_EPOCHS = 1000.0, 50, 3
CLS_EPOCHS = 40
CLEAN_ACC_BAR = 0.8

NERF_H = 800
NERF_STEPS = 30
NERF_RENDER_LIMIT_S = 120.0    # above this estimate the view renders at 400²
K45_POINTS = 1024 * (64 + 192)  # a train step: 64 coarse + 192 fine per ray
K3_QUERIES = 65536


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


def bound(nbytes: float, ops: float, peak_bytes: float, peak_ops: float):
    """(bound_ms, bound_by) of a kernel that moves `nbytes` and does `ops`."""
    t_bytes, t_ops = nbytes / peak_bytes, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def launch_counts():
    """Every kernel wrapper's launch counter, by kernel."""
    from nerfail_tpu_torch.ops.cuda.knn_kernel import knn_sq_cuda
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        mlp_backward, mlp_forward,
    )
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        segment_sq, segment_sum,
    )

    return {"K1": segment_sum.launches, "K2": segment_sq.launches,
            "K3": knn_sq_cuda.launches,
            "K3 merge": knn_sq_cuda.merge_launches,
            "K4": mlp_forward.launches, "K5": mlp_backward.launches}


def zero_counts() -> None:
    from nerfail_tpu_torch.ops.cuda.knn_kernel import knn_sq_cuda
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        mlp_backward, mlp_forward,
    )
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        segment_sq, segment_sum,
    )

    for fn in (segment_sum, segment_sq, knn_sq_cuda, mlp_forward,
               mlp_backward):
        fn.launches = 0
    knn_sq_cuda.merge_launches = 0


def white_resized(rgba, dev):
    """White-composited RGB at the classifier's size, [N, 299, 299, 3]."""
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        resize_batch, white_composite_255,
    )

    x = torch.as_tensor(rgba, device=dev).to(torch.float32)
    return resize_batch(white_composite_255(x[..., :3], x[..., 3:4]), RESIZE)


def inception_phase(dev):
    """The attack's target: Inception-V3 trained on the 800² box classes
    through the attack's resize, in deterministic cuDNN algorithms."""
    import torch

    from nerfail_tpu_torch.eval import asr_800

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    data = asr_800.class_data(size=H, resize=RESIZE, device=dev)
    model, info = asr_800.train_inception(data, device=dev,
                                          epochs=CLS_EPOCHS)
    torch.backends.cudnn.deterministic = False
    log(f"[inception] {len(data['tr_y'])} train views, {CLS_EPOCHS} epochs "
        f"in {info['train_s']:.3f} s; best val_acc {info['val_acc']:.4f} "
        f"at epoch {info['best_epoch']}, kept")
    return model


def tables(K, poses, S, dev):
    """Every view's 8-NN table (K3) and Gaussian weights."""
    import torch

    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
    from nerfail_tpu_torch.pointset.weights import gauss_weights

    prep = KnnPrep(S, device=dev)
    ws, ids, d0 = [], [], None
    for v in range(len(poses)):
        cm = analytic_coord_map(poses[v], H, H, K)
        d, i = build_index_and_dist(cm, S, method="device", device=dev,
                                    prep=prep)
        ws.append(gauss_weights(d, c=GAUSS_C * 800.0 / H))
        ids.append(i)
        if v == 0:
            d0 = d
    return torch.stack(ws), torch.stack(ids), d0, prep


def attack_report(dev, mp, delta, name):
    """evaluate_attack on the views attacked by δ, then evaluate_testset
    on the same views, whose ASR must be the same."""
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
    log(f"[eval] {name}, {N_VIEWS} views at {H}²: {json.dumps(report)}")
    require(report["e_max"] <= EPS + 1e-3, f"{name}: e_max ≤ ε")
    require(all(np.isfinite(v) for v in report.values()
                if isinstance(v, float) and v != float("inf")),
            f"{name}: report finite")
    ts = evaluate_testset(mp["logits_fn"], attacked,
                          np.zeros(N_VIEWS, np.int64), attacked_class=0,
                          original_images=mp["clean"],
                          num_classes=N_CLASSES, batch_size=BATCH,
                          device=dev)
    require(ts["asr"] == report["asr"],
            f"{name}: evaluate_testset's ASR is evaluate_attack's")
    return report


def nerfail_s_path(dev, K, poses, ori, S, model):
    """Tables → NeRFail-S, through the entry points, with the launch
    counters set to 0 before the tables and read after the attack."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        make_classifier_logits_fn, zero_init_mask,
    )
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.eval.harness import predict_all

    zero_counts()
    t0 = time.time()
    weights, idx, d_view0, prep = tables(K, poses, S, dev)
    torch.cuda.synchronize()
    tables_s = time.time() - t0
    logits_fn = make_classifier_logits_fn(model)
    ori_d = torch.from_numpy(ori).to(dev)
    with torch.no_grad():
        clean = torch.cat([white_resized(ori_d[s:s + BATCH], dev).cpu()
                           for s in range(0, N_VIEWS, BATCH)]).numpy()
    clean_acc = float(np.mean(predict_all(logits_fn, clean, BATCH,
                                          device=dev) == 0))
    require(clean_acc >= CLEAN_ACC_BAR,
            f"clean accuracy {clean_acc} on the attacked views ≥ "
            f"{CLEAN_ACC_BAR}")
    delta0 = zero_init_mask(ori[list(MASK_VIEWS)].astype(np.float32)).numpy()
    cfg = AttackConfig(method="NeRFail_S", eps=EPS, a=STEP_A,
                       batch_size=BATCH)
    t0 = time.time()
    res = nerfail_s_attack(
        delta0, weights, idx, ori_d, np.zeros(N_VIEWS, np.int64), logits_fn,
        cfg, resize_to=RESIZE, epochs=EPOCHS, device=dev)
    torch.cuda.synchronize()
    attack_s = time.time() - t0
    launches = launch_counts()
    n_steps = EPOCHS * -(-N_VIEWS // BATCH)
    log(f"[nerfail-s] tables {tables_s:.3f} s, clean accuracy "
        f"{clean_acc:.4f}, attack {attack_s:.3f} s; launches {launches}")
    require(launches["K1"] == n_steps, f"K1 once a step ({n_steps})")
    require(launches["K3"] == N_VIEWS, f"K3 search once a view ({N_VIEWS})")
    require(0 < launches["K3 merge"] <= N_VIEWS,
            "K3 merge at most once a view, and in some view")
    mp = {"weights": weights, "idx": idx, "ori_d": ori_d, "clean": clean,
          "logits_fn": logits_fn, "delta0": delta0, "prep": prep}
    mp.update(res=res, report=attack_report(dev, mp, res.delta, "NeRFail-S"),
              launches=launches)
    check_outputs(mp, d_view0, S)
    return mp


def check_outputs(mp, d_view0, S):
    import numpy as np
    import torch

    res, delta0 = mp["res"], mp["delta0"]
    d = res.delta
    require(d.shape == (len(MASK_VIEWS), H, H, 4), f"δ shape {d.shape}")
    require(np.isfinite(d).all(), "δ finite")
    require(np.array_equal(d[..., 3], delta0[..., 3]), "δ keeps δ0's alpha")
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
    require(bool((d_view0[..., 0] == 0).all()), "self-distance 0")
    for h in res.history:
        require(0 <= h["attack_acc"] <= 1 and 0 <= h["clean_acc"] <= 1,
                "history accuracies")


def nerfail_path(dev, mp):
    """NeRFail on the same tables: batched DeepFool through K2 and the K1
    pick, with the reference control plane."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.config import AttackConfig

    cfg = AttackConfig(method="NeRFail", eps=EPS, m2=DF_M2,
                       df_max_iter=DF_MAX_ITER, view_batch=BATCH)
    zero_counts()
    t0 = time.time()
    res = nerfail_attack(mp["delta0"], mp["weights"], mp["idx"],
                         mp["ori_d"], mp["logits_fn"], cfg,
                         resize_to=RESIZE, epochs=DF_EPOCHS, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
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
        f"in {wall:.3f} s, {flipped} views flipped before the cap; "
        f"launches {launches}")
    require(loops > 0, "NeRFail ran DeepFool")
    require(launches["K2"] == loops,
            "K2 once per DeepFool iteration, as the per-view iterations imply")
    require(launches["K1"] == loops, "K1 (pick) once per DeepFool iteration")
    d = res.delta
    require(d.shape == mp["delta0"].shape and np.isfinite(d).all(),
            "NeRFail δ shape, finite")
    require(np.array_equal(d[..., 3], mp["delta0"][..., 3]),
            "NeRFail δ keeps δ0's alpha")
    require(np.abs(d[..., :3]).max() <= 255.0, "NeRFail δ clamp")
    report = attack_report(dev, mp, d, "NeRFail")
    require(flipped > 0 and report["asr"] > 0,
            "DeepFool flipped at least one view, and the attack keeps one")
    return {"res": res, "loops": loops, "cfg": cfg, "report": report,
            "launches": launches}


def k1_phase(dev, mp, M, peaks):
    """K1 at NeRFail-S's shapes, on a real step's cotangent."""
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
    plan = build_csr_plan(idx, w, M, pair_mask=mask)
    delta = torch.from_numpy(mp["res"].delta).to(dev).reshape(-1, 4)
    splat = splat_forward(delta, idx, w).requires_grad_(True)
    out = composite_after_splat(splat, ori, eps=EPS)
    logits = mp["logits_fn"](resize_batch(out["cla_x"], RESIZE))
    labels = torch.zeros(BATCH, dtype=torch.int64, device=dev)
    (g,) = torch.autograd.grad(F.cross_entropy(logits, labels), splat)
    g = g.reshape(-1, 4).contiguous()

    k = segment_sum(g, plan)
    ref = segment_sum_plain(g, plan)
    torch.cuda.synchronize()
    require(torch.equal(k, segment_sum(g, plan)), "K1 bit-equal across runs")
    err = (k - ref).abs()
    require(bool((err <= error_bound(g, plan)).all()),
            "K1 within the fp32 sum bound")
    require(float(ref.abs().max()) > 0, "K1 cotangent is not all zero")

    ms = cuda_ms(lambda: segment_sum(g, plan), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: segment_sum_plain(g, plan), reps=5)
    pt = plan_point_ids(plan)
    contrib = plan.w[:, None] * g[plan.pix.long()]
    acc = torch.zeros(M, 4, device=dev)
    library_ms = cuda_ms(lambda: acc.index_add_(0, pt, contrib), reps=5)
    P, R, C = plan.n_pairs, plan.n_rows, 4
    nbytes = 8 * P + 4 * C * int(mask.sum()) + 4 * (2 * R + 1) + 4 * C * M
    bound_ms, bound_by = bound(nbytes, 2 * P * C, peaks.bytes_per_s,
                               peaks.fp32)
    row = {"max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": "index_add_",
           "bound_ms": bound_ms, "bound_by": bound_by, "n_pairs": P,
           "n_rows": R}
    log(f"[K1] {json.dumps(row)}")
    return row


def k2_phase(dev, mp, df, M, peaks):
    """K2 on one real DeepFool iteration's Gdiff stack at full width
    ([8·800², 32]: 8 classes × RGBA), and K1 as the engine's pick of that
    iteration, reading the chosen classes out of the stack in place."""
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        composite_after_splat, resize_batch, splat_attack_forward,
    )
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        build_batched_csr_plan, class_rows, error_bound, plan_point_ids,
        segment_sq, segment_sq_plain, segment_sum, segment_sum_class,
        segment_sum_class_plain, sq_error_bound,
    )
    from nerfail_tpu_torch.ops.splat import (
        deepfool_cotangents, splat_forward_batched,
    )

    V = BATCH
    sl = slice(0, V)
    w, idx = mp["weights"][sl], mp["idx"][sl]
    ori = mp["ori_d"][sl].to(torch.float32)
    plan = build_batched_csr_plan(idx, w, M, pair_mask=ori[..., 3:] > 0)
    delta = torch.from_numpy(df["res"].delta).to(dev)
    with torch.no_grad():
        ori_logits = splat_attack_forward(
            delta.reshape(-1, 4), w, idx, ori, mp["logits_fn"], eps=EPS,
            resize_to=RESIZE, device=dev)["ori_logits"]
    ori_label = torch.argmax(ori_logits, -1)

    def head(pix):
        out = composite_after_splat(pix, ori, eps=EPS)
        return mp["logits_fn"](resize_batch(out["cla_x"], RESIZE))

    points_b = delta.reshape(1, M, 4).expand(V, M, 4).contiguous()
    with torch.no_grad():
        pix = splat_forward_batched(points_b, idx, w)
    logits, G = deepfool_cotangents(head, pix, N_CLASSES, ori_label)
    C = G.shape[1]

    k = segment_sq(G, plan)
    ref = segment_sq_plain(G, plan)
    torch.cuda.synchronize()
    require(torch.equal(k, segment_sq(G, plan)), "K2 bit-equal across runs")
    err = (k - ref).abs()
    require(bool((err <= sq_error_bound(G, plan)).all()),
            "K2 within sq_error_bound")
    require(float(ref.max()) > 0, "K2 norms are not all zero")
    ms = cuda_ms(lambda: segment_sq(G, plan), reps=20, warmup=2)
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
    kept_pix = int((ori[..., 3] > 0).sum())
    nbytes = 8 * P + 4 * C * kept_pix + 4 * (R + 1) + 4 * (V + 1) + 4 * V * C
    bound_ms, bound_by = bound(nbytes, 2 * P * C + 2 * R * C,
                               peaks.bytes_per_s, peaks.fp32)
    k2 = {"max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
          "library_ms": None, "composite_ms": composite_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "n_pairs": P,
          "n_rows": R}
    log(f"[K2] Gdiff stack {tuple(G.shape)}: {json.dumps(k2)}")

    # K1 as the engine's pick: each view's class as deepfool_batch
    # chooses it from these logits and norms, read out of the stack
    views = torch.arange(V, device=dev)
    sq = k.view(V, N_CLASSES, 4).sum(-1)
    f = logits - logits[views, ori_label][:, None] - df["cfg"].m2
    value = f.abs() / (sq.sqrt() + 1e-4)
    value[views, ori_label] = float("inf")
    choice = value.argmin(-1)
    pk = segment_sum_class(G, choice, plan)
    gsel = class_rows(G, choice, plan, 4)
    pref = segment_sum_class_plain(G, choice, plan)
    torch.cuda.synchronize()
    require(torch.equal(pk, segment_sum_class(G, choice, plan)),
            "K1 pick bit-equal across runs")
    require(torch.equal(pk, segment_sum(gsel, plan)),
            "K1 pick in place bit-equal to K1 on the gathered class")
    perr = (pk - pref).abs()
    require(bool((perr <= error_bound(gsel, plan)).all()),
            "K1 pick within the fp32 sum bound")
    untouched = torch.ones(V * M, dtype=torch.bool, device=dev)
    untouched[plan.rows.long()] = False
    require(bool((pk[untouched] == 0).all()), "K1 pick: untouched rows 0")
    require(bool(torch.isfinite(pk).all()) and float(pk.abs().max()) > 0,
            "K1 pick finite and not all zero")
    pick_nbytes = (8 * P + 4 * 4 * kept_pix + 4 * (2 * R + 1)
                   + 4 * 4 * V * M)
    pick = {"pick_max_abs_err": float(perr.max()),
            "pick_ms": cuda_ms(lambda: segment_sum_class(G, choice, plan),
                               reps=20, warmup=2),
            "pick_plain_ms": cuda_ms(
                lambda: segment_sum_class_plain(G, choice, plan), reps=3),
            "pick_bound_ms": bound(pick_nbytes, 2 * P * 4,
                                   peaks.bytes_per_s, peaks.fp32)[0]}
    log(f"[K1 pick] classes {choice.tolist()}: {json.dumps(pick)}")
    return k2, pick


def k3_phase(dev, mp, K, poses, S, peaks):
    """K3 on 64 K queries of view 0 against all 1.92 M points (against the
    plain brute force), then on the whole view: the split search against
    one work item a row (bit-equal, ties included)."""
    import torch

    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.ops.cuda.knn_kernel import (
        KnnQueryPlan, knn, knn_plain, knn_sq_cuda,
    )

    prep = mp["prep"]
    M = S.shape[0]
    cm = analytic_coord_map(poses[0], H, H, K).reshape(-1, 3)
    mid = cm.shape[0] // 2
    q = cm[max(0, mid - K3_QUERIES // 2): mid + K3_QUERIES // 2]
    plan = KnnQueryPlan(q, prep)
    d, i = knn(plan=plan)
    qt, pt = torch.from_numpy(q).to(dev), torch.from_numpy(S).to(dev)
    d9, i9 = knn_plain(qt, pt, k=9, q_chunk=8192, p_tile=32768)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(d).all()), "K3 distances finite")
    require(torch.equal(d, d9[:, :8]),
            "K3 distances bit-equal to the plain version")
    untied = torch.ones(q.shape[0], 8, dtype=torch.bool, device=dev)
    untied[:, 1:] &= d9[:, 1:8] != d9[:, :7]
    untied &= d9[:, :8] != d9[:, 1:9]
    require(torch.equal(i.long()[untied], i9[:, :8][untied]),
            "K3 indices match wherever the distance is not tied")
    work = plan.work()
    ms = cuda_ms(lambda: knn_sq_cuda(plan.qpk, prep.ppk, plan.tiles, work, M),
                 reps=3)
    plain_ms = cuda_ms(lambda: knn_plain(qt, pt, k=8, q_chunk=8192,
                                         p_tile=32768), reps=1, warmup=0)

    def k3_bound(p):
        # the queries, the packed points, the CSR and the output, each
        # once; 8 non-FMA operations a pair, at half the FMA-counted rate
        nbytes = (4 * p.qpk.numel() + 4 * prep.ppk.numel()
                  + 4 * (p.tiles.numel() + p.row_ptr.numel())
                  + p.n_q * p.tq * 8 * 8)
        return bound(nbytes, 8 * p.pair_count(), peaks.bytes_per_s,
                     peaks.fp32 / 2)

    bound_ms, bound_by = k3_bound(plan)

    vplan = KnnQueryPlan(torch.from_numpy(cm).to(dev), prep)
    vwork = vplan.work()
    split = knn_sq_cuda(vplan.qpk, prep.ppk, vplan.tiles, vwork, M)
    one = knn_sq_cuda(vplan.qpk, prep.ppk, vplan.tiles,
                      vplan.work(vplan.max_c()), M)
    torch.cuda.synchronize()
    require(torch.equal(split[0], one[0]) and torch.equal(split[1], one[1]),
            "K3 split search + merge bit-equal to one item a row")
    view_ms = cuda_ms(lambda: knn_sq_cuda(vplan.qpk, prep.ppk, vplan.tiles,
                                          vwork, M), reps=3)
    row = {"max_abs_err": float((d - d9[:, :8]).abs().max()), "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "queries": q.shape[0], "points": M,
           "view_ms": view_ms, "view_bound_ms": k3_bound(vplan)[0],
           "view_items": vwork.items.shape[0],
           "view_split_rows": vwork.merges.shape[0]}
    log(f"[K3] {json.dumps(row)}")
    return row


def nerf_train_path(dev):
    """train_nerf at full width on the 800² box scene (8 train views),
    through the entry point; K4 and K5 launch twice per step."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.config import (
        ExperimentConfig, NeRFModelConfig, RenderConfig, TrainConfig,
    )
    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import make_box_scene
    from nerfail_tpu_torch.train.nerf_trainer import train_nerf

    scene = make_box_scene(n_train=8, n_val=1, n_test=1, H=NERF_H, W=NERF_H)
    targets = white_background_composite(scene.images)
    cfg = ExperimentConfig(
        model=NeRFModelConfig(),
        render=RenderConfig(N_samples=64, N_importance=128, chunk=32768),
        train=TrainConfig(N_rand=1024, precrop_iters=10, i_print=1))
    losses = []
    zero_counts()
    t0 = time.time()
    state = train_nerf(cfg, targets, scene.poses, scene.K, scene.i_train,
                       n_iters=NERF_STEPS, device=dev,
                       log_fn=lambda i, m: losses.append(m["loss"]))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    log(f"[nerf train] {NERF_STEPS} steps in {wall:.3f} s; loss "
        f"{losses[0]:.5f} → {losses[-1]:.5f}; launches {launches}")
    require(launches["K4"] == 2 * NERF_STEPS
            and launches["K5"] == 2 * NERF_STEPS,
            f"K4 and K5 twice per step ({2 * NERF_STEPS})")
    require(all(np.isfinite(v) for v in losses), "finite losses")
    return {"state": state, "cfg": cfg, "scene": scene,
            "launches": launches}


def nerf_render_path(dev, nt, k4_ms):
    """extract_coord_maps for one test view at full width: K4 twice per
    chunk. The view renders at 400² if the kernel's measured rate says
    800² would take longer than NERF_RENDER_LIMIT_S."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.pointset.extract import extract_coord_maps

    cfg, scene = nt["cfg"], nt["scene"]
    est_s = k4_ms * 1e-3 * NERF_H * NERF_H * 256 / K45_POINTS
    size = NERF_H if est_s <= NERF_RENDER_LIMIT_S else NERF_H // 2
    K = scene.K.copy()
    K[:2] *= size / NERF_H
    zero_counts()
    t0 = time.time()
    coords, rgbs = extract_coord_maps(nt["state"].params, cfg,
                                      scene.poses[scene.i_test[:1]], size,
                                      size, K)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = launch_counts()
    chunks = -(-size * size // cfg.render.chunk)
    log(f"[nerf render] one {size}² view, {chunks} chunks: {render_s:.3f} "
        f"s; launches {launches}")
    require(launches["K4"] == 2 * chunks and launches["K5"] == 0,
            f"K4 twice per chunk ({chunks}), K5 none")
    require(coords.shape == (1, size, size, 3) and np.isfinite(coords).all(),
            "pts_max finite [1, H, W, 3]")
    require(rgbs.min() >= -1e-5 and rgbs.max() <= 1 + 1e-5, "rgb in [0, 1]")
    return {"k4": launches["K4"], "size": size}


def k45_phase(dev, peaks):
    """K4 and K5 against their plain versions at a train step's shapes:
    1024 rays × (64 coarse + 192 fine) samples = 262 144 points, 8×256,
    seeded inputs; the library yardstick is the same network in bf16
    torch.matmul (cuBLAS) through apply_nerf."""
    import torch

    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.models.nerf import apply_nerf, init_nerf_params
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        MlpDims, mlp_backward, mlp_backward_plain, mlp_forward,
        mlp_forward_plain, pack_input, pack_params,
    )
    from nerfail_tpu_torch.ops.encoding import positional_encoding

    n = K45_POINTS
    cfg = NeRFModelConfig()
    dims = MlpDims.from_cfg(cfg)
    params = init_nerf_params(torch.Generator().manual_seed(SEED), cfg, dev)
    fw, fb = (t.detach().contiguous() for t in pack_params(params, dims))
    gen = torch.Generator().manual_seed(SEED + 1)
    # points in the cube the box scene's rays cross (cameras at radius 4)
    pts = torch.rand(n, 3, generator=gen) * 8.0 - 4.0
    vd = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen),
                                       dim=-1)
    g = (torch.randn(n, 4, generator=gen) * 1e-3).to(dev)
    xin = pack_input(pts, vd).to(dev)

    out = mlp_forward(xin, fw, fb, dims)
    ref = mlp_forward_plain(xin, fw, fb, dims)
    torch.cuda.synchronize()
    require(torch.equal(out, mlp_forward(xin, fw, fb, dims)),
            "K4 bit-equal across launches")
    errs = {"out": (float((out - ref).abs().max()), float(ref.abs().max()))}

    # K5, as training runs it (no input gradients) and with them
    dx_none, dw, db = mlp_backward(xin, fw, fb, g, dims, False)
    _, dw2, db2 = mlp_backward(xin, fw, fb, g, dims, False)
    dx, dwi, dbi = mlp_backward(xin, fw, fb, g, dims, True)
    rx, rw, rb = mlp_backward_plain(xin, fw, fb, g, dims, True)
    torch.cuda.synchronize()
    require(dx_none is None, "K5 without input gradients gives None")
    require(torch.equal(dw, dw2) and torch.equal(db, db2),
            "K5 bit-equal across launches")
    require(torch.equal(dw, dwi) and torch.equal(db, dbi),
            "K5 dW/db do not depend on the input-gradient flag")
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
    # the same bf16 operands summed in another order; an activation whose
    # f32 value differs in its last bit may round to a bf16 one ulp (2⁻⁸)
    # away: 2 % of the tensor's largest entry. d_pts is held by its
    # relative L2 error (2 %): the encoding jacobian scales each channel by
    # up to 2⁹ and sums 63 terms that cancel
    for k, (e, scale) in errs.items():
        require(e <= 0.02 * scale,
                f"K4/K5 {k}: |kernel − plain| {e:.3e} vs scale {scale:.3e}")
    require(d_pts_rel <= 0.02, f"K4/K5 d_pts relative L2 error {d_pts_rel}")

    lib_params = {k: v.detach().to(torch.bfloat16).requires_grad_(True)
                  for k, v in params.items()}
    pts_d, vd_d = pts.to(dev), vd.to(dev)

    def library(requires_grad):
        x = positional_encoding(pts_d, cfg.multires).to(torch.bfloat16)
        v = positional_encoding(vd_d, cfg.multires_views).to(torch.bfloat16)
        with torch.set_grad_enabled(requires_grad):
            y = apply_nerf(lib_params, cfg, x, v)
            if requires_grad:
                torch.autograd.grad(y, list(lib_params.values()),
                                    g.to(torch.bfloat16))

    ms4 = cuda_ms(lambda: mlp_forward(xin, fw, fb, dims), reps=10, warmup=2)
    plain4 = cuda_ms(lambda: mlp_forward_plain(xin, fw, fb, dims), reps=3)
    lib4 = cuda_ms(lambda: library(False), reps=10, warmup=2)
    ms5 = cuda_ms(lambda: mlp_backward(xin, fw, fb, g, dims, False),
                  reps=10, warmup=2)
    plain5 = cuda_ms(lambda: mlp_backward_plain(xin, fw, fb, g, dims, False),
                     reps=3)
    lib5 = cuda_ms(lambda: library(True), reps=10, warmup=2)

    macs = dims.macs_per_point()
    w_bytes = 2 * fw.numel() + 4 * fb.numel()
    rows = {}
    # K5: the recompute, the weight gradients and the activation
    # gradients, without layer 0's (no input gradients in training)
    for name, ms, plain, lib, flops, nbytes in (
            ("K4", ms4, plain4, lib4, 2 * n * macs,
             n * (32 + 16) + w_bytes),
            ("K5", ms5, plain5, lib5,
             2 * n * (3 * macs - dims.in_pad * dims.width),
             n * (32 + 16) + w_bytes + 4 * (fw.numel() + fb.numel()))):
        bound_ms, bound_by = bound(nbytes, flops, peaks.bytes_per_s,
                                   peaks.bf16)
        rows[name] = {
            "max_abs_err": max(e for k, (e, _) in errs.items()
                               if (k == "out") == (name == "K4")),
            "ms": ms, "plain_ms": plain, "library_ms": lib,
            "library": "bf16 apply_nerf " + ("forward" if name == "K4"
                                             else "forward + backward"),
            "bound_ms": bound_ms, "bound_by": bound_by, "points": n,
            "flops": flops}
        log(f"[{name}] {json.dumps(rows[name])}")
    rows["K5"]["d_pts_rel_l2"] = d_pts_rel
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from nerfail_tpu_torch.eval.asr_800 import attack_scene, attack_views
        from nerfail_tpu_torch.ops.cuda import build
        from nerfail_tpu_torch.utils.profiling import card_peaks
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    log(f"card: {card_line()}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    peaks = card_peaks(dev)
    t0 = time.time()
    build.build_all()
    log(f"[build] {time.time() - t0:.3f} s")

    walls = {}
    t0 = time.time()
    model = inception_phase(dev)
    walls["inception"] = time.time() - t0
    K, poses = attack_scene(N_VIEWS, H, seed=SEED)
    ori, S = attack_views(K, poses, H, MASK_VIEWS)
    M = S.shape[0]
    require(M == len(MASK_VIEWS) * H * H, "M = 3·800²")
    t0 = time.time()
    mp = nerfail_s_path(dev, K, poses, ori, S, model)
    walls["nerfail_s"] = time.time() - t0
    t0 = time.time()
    df = nerfail_path(dev, mp)
    walls["nerfail"] = time.time() - t0
    t0 = time.time()
    k1 = k1_phase(dev, mp, M, peaks)
    k2, pick = k2_phase(dev, mp, df, M, peaks)
    k3 = k3_phase(dev, mp, K, poses, S, peaks)
    walls["k1_k2_k3"] = time.time() - t0
    t0 = time.time()
    nt = nerf_train_path(dev)
    k45 = k45_phase(dev, peaks)
    nr = nerf_render_path(dev, nt, k45["K4"]["ms"])
    walls["nerf"] = time.time() - t0
    for name, rep in (("NeRFail-S", mp["report"]), ("NeRFail", df["report"])):
        log(f"[summary] {name} at {H}² against the trained Inception-V3: "
            f"ASR {rep['asr']:.4f}, clean accuracy "
            f"{rep['clean_acc_target_class']:.4f}, e_max {rep['e_max']:.4f}")
    log(f"[walls] host clock, seconds: {json.dumps(walls)}")

    rows = [
        {"name": "K1 splat-backward segmented sum",
         "source": "nerfail_tpu_torch/csrc/segsum.cu",
         "launches": mp["launches"]["K1"],
         "nerfail_launches": df["launches"]["K1"], **k1, **pick},
        {"name": "K2 squared norms of the segmented sum",
         "source": "nerfail_tpu_torch/csrc/segsum_sq.cu",
         "launches": df["launches"]["K2"], **k2},
        {"name": "K3 exact 8-NN (split search + stable merge)",
         "source": "nerfail_tpu_torch/csrc/knn.cu",
         "launches": mp["launches"]["K3"],
         "merge_launches": mp["launches"]["K3 merge"], **k3},
        {"name": "K4 fused NeRF encoding + MLP forward",
         "source": "nerfail_tpu_torch/csrc/nerf_mlp.cu",
         "launches": nt["launches"]["K4"], "render_launches": nr["k4"],
         **k45["K4"]},
        {"name": "K5 fused NeRF MLP backward (recompute)",
         "source": "nerfail_tpu_torch/csrc/nerf_mlp.cu",
         "launches": nt["launches"]["K5"], **k45["K5"]},
    ]
    log(json.dumps({"kernels": rows}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
