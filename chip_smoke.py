#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerfail_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of the repository. It needs one CUDA device and nvcc,
and exits non-zero without a result line when either is missing.

1. builds the CUDA kernels from nerfail_tpu_torch/csrc (one nvcc each, in
   parallel);
2. drives the port's two paths at full width, through their entry
   points, each with every kernel launch counter set to 0 just before and
   read just after: 16 views of the box scene at 800², a point set of
   3·800² = 1.92 M points from 3 mask views, the 8-NN tables by K3
   (build_index_and_dist) and their Gaussian weights, against
   Inception-V3 at 299² with 8 classes from a seeded random init:
   a. NeRFail-S (ε = 32, a = 2, batch 8, 2 epochs: 4 steps, each through
      K1), and evaluate_attack on the result;
   b. NeRFail on the same tables (ε = 32, m1 = 0, m2 = 100, view batch 8,
      DeepFool ≤ 12 iterations, 2 epochs): every DeepFool iteration runs
      one K2 launch for the 8 class norms and one K1 launch for the chosen
      class. m1 = 0 keeps the m1 bisection from repeating epoch 0 up to the
      epoch cap when no view flips, as against a random init it does not.
   The init is random because the repo holds no trained weights: the ASR
   these print is not an attack result;
3. checks what came out: shapes, finite values, the ε-ball, exact
   self-distances, K1/K2 launch counts against the engine evaluations
   that the history's per-view DeepFool iterations imply, and 32² runs
   of both engines whose CUDA path must agree with the port's CPU path
   (the plain versions, held against JAX by the tests);
4. trains SimpleCNN with the port's trainer on the 64² box classes and
   attacks it with both engines (tests/test_asr.py's fixture): the port's
   first attack results on the card, 64² / SimpleCNN, not the paper's
   setting;
5. holds each kernel against its plain PyTorch version on the card at
   the paths' shapes (K1 both as NeRFail-S's backward and as the
   DeepFool pick), times kernel, plain version and library call, and
   computes each kernel's bound from this run's inputs; times K1/K2 on
   plans that list only touched rows against plans that list every row;
6. walks DeepFool on batch 0 (time per iteration; the summed step must
   be finite, nonzero and keep alpha), and profiles one steady NeRFail-S
   step and one DeepFool iteration (device busy share, top kernels).

Its last lines are one JSON object {"kernels": [...]}, the card's name and
power limit, and {"ok": true, "device": {...}}.
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
DF_MAX_ITER, DF_EPOCHS = 12, 2   # NeRFail: DeepFool cap, attack epochs

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) flop/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


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
    import numpy as np

    from nerfail_tpu_torch.data.poses import pose_spherical

    rng = np.random.default_rng(SEED)
    focal = 0.5 * size / np.tan(0.5 * 0.6911112070083618)
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]],
                 np.float32)
    thetas = rng.uniform(-180, 180, n_views)
    phis = rng.uniform(-60, -10, n_views)
    poses = np.stack([pose_spherical(t, p, 4.0)
                      for t, p in zip(thetas, phis)]).astype(np.float32)
    return K, poses


def views(K, poses, size: int):
    """uint8 RGBA renders [N, size, size, 4] and the point set S."""
    import numpy as np

    from nerfail_tpu_torch.data.synthetic import _shade, analytic_coord_map
    from nerfail_tpu_torch.ops.rays import get_rays_np

    ori = np.empty((len(poses), size, size, 4), np.uint8)
    for v, pose in enumerate(poses):
        o, d = get_rays_np(size, size, K, pose)
        rgba = _shade(o.reshape(-1, 3), d.reshape(-1, 3))
        ori[v] = np.clip(rgba * 255.0, 0, 255).astype(np.uint8).reshape(
            size, size, 4)
    S = np.concatenate([analytic_coord_map(poses[v], size, size, K)
                        .reshape(-1, 3) for v in MASK_VIEWS])
    return ori, S


def tables(K, poses, S, size, dev, prep=None):
    import torch

    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
    from nerfail_tpu_torch.pointset.weights import gauss_weights

    ws, ids, d0 = [], [], None
    for v in range(len(poses)):
        cm = analytic_coord_map(poses[v], size, size, K)
        d, i = build_index_and_dist(cm, S, method="device", device=dev,
                                    prep=prep)
        ws.append(gauss_weights(d, c=GAUSS_C * 800.0 / size))
        ids.append(i)
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
    the layout without touched-row compaction, to time the choice."""
    import dataclasses

    import torch

    dev, N, V = plan.device, plan.num_points, plan.n_views
    counts = torch.zeros(N, dtype=torch.int32, device=dev)
    counts[plan.rows.long()] = torch.diff(plan.row_ptr)
    row_ptr = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return dataclasses.replace(
        plan, row_ptr=row_ptr,
        rows=torch.arange(N, dtype=torch.int32, device=dev),
        view_ptr=torch.arange(V + 1, dtype=torch.int32, device=dev) * (N // V),
        view_rows=(N // V,) * V)


def main_path(dev, K, poses, ori, S):
    """Tables → NeRFail-S → evaluate_attack, through the entry points."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        make_classifier_logits_fn, splat_attack_forward, zero_init_mask,
    )
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.eval.harness import evaluate_attack
    from nerfail_tpu_torch.models.classifiers.inception_v3 import InceptionV3
    from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep

    out = {}
    torch.cuda.synchronize()
    t0 = time.time()
    prep = KnnPrep(S, device=dev)
    weights, idx, d_view0 = tables(K, poses, S, H, dev, prep=prep)
    torch.cuda.synchronize()
    out["tables_s"] = time.time() - t0
    log(f"[tables] {N_VIEWS} views × {H}², M = {S.shape[0]}: "
        f"{out['tables_s']:.3f} s (host planning + K3)")

    torch.manual_seed(SEED)
    model = InceptionV3(num_classes=N_CLASSES).to(dev)
    logits_fn = make_classifier_logits_fn(model)
    delta0 = zero_init_mask(ori[list(MASK_VIEWS)].astype(np.float32)).numpy()
    labels = np.zeros(N_VIEWS, np.int64)
    cfg = AttackConfig(method="NeRFail_S", eps=EPS, a=STEP_A,
                       batch_size=BATCH)
    ori_d = torch.from_numpy(ori).to(dev)
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

    attacked, clean = [], []
    with torch.no_grad():
        for s in range(0, N_VIEWS, BATCH):
            sl = slice(s, s + BATCH)
            o = splat_attack_forward(
                res.delta.reshape(-1, 4), weights[sl], idx[sl], ori_d[sl],
                logits_fn, eps=EPS, resize_to=RESIZE, device=dev)
            attacked.append(white_resized(o["attacked_rgba"], dev).cpu())
            clean.append(white_resized(ori_d[sl], dev).cpu())
    attacked = torch.cat(attacked).numpy()
    clean = torch.cat(clean).numpy()
    report = evaluate_attack(logits_fn, attacked, clean, true_label=0,
                             num_classes=N_CLASSES, batch_size=BATCH,
                             device=dev)
    log("[eval] evaluate_attack, RANDOM-INIT classifier (no trained "
        f"weights; not an attack result): {json.dumps(report)}")
    out.update(res=res, report=report, weights=weights, idx=idx,
               d_view0=d_view0, delta0=delta0, prep=prep, ori_d=ori_d,
               logits_fn=logits_fn, attacked=attacked)
    return out


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
    P, R, C = plan.n_pairs, plan.n_rows, 4
    kept_pix = int(mask.sum())
    nbytes = 8 * P + 4 * C * kept_pix + 4 * (2 * R + 1) + 4 * C * M
    bound_ms = max(nbytes / PEAK_BYTES, 2 * P * C / PEAK_FP32) * 1e3
    log(f"[K1] max |kernel − plain| {max_err:.3e} (≤ per-entry fp32 bound "
        f"max {float(bound.max()):.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({nbytes} bytes)")
    log(f"[plan] NeRFail-S K1, touched rows vs every row: {ms:.4f} vs "
        f"{every_row_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / PEAK_BYTES
            >= 2 * P * C / PEAK_FP32 else "operations",
            "n_pairs": P, "n_rows": R, "plan_ms": plan_ms,
            "every_row_ms": every_row_ms}


def k3_phase(dev, mp, K, poses, S):
    """K3 on 64 K queries of view 0 against all 1.92 M points, and the
    kernel alone on the whole view."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.ops.cuda.knn_kernel import (
        KnnQueryPlan, knn, knn_plain, knn_sq_cuda,
    )

    prep = mp["prep"]
    M = S.shape[0]
    cm = analytic_coord_map(poses[0], H, H, K).reshape(-1, 3)
    mid = cm.shape[0] // 2
    q = cm[mid - 32768: mid + 32768]

    def bound(plan):
        ops = 8 * plan.pair_count()
        nbytes = (plan.qpk.nbytes + 4 * 3 * prep.Mp + plan.cand.nbytes
                  + plan.n_q * plan.tq * 8 * 8)
        return (max(nbytes / PEAK_BYTES, ops / PEAK_FP32) * 1e3,
                "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_FP32
                else "operations")

    def kernel_ms(plan):
        qpk = torch.from_numpy(plan.qpk).to(dev)
        cand = torch.from_numpy(plan.cand).to(dev)
        return cuda_ms(lambda: knn_sq_cuda(qpk, prep.ppk, cand, M), reps=3)

    t0 = time.time()
    plan = KnnQueryPlan(q, prep)
    plan_s = time.time() - t0
    d, i = knn(plan=plan)
    qt, pt = torch.from_numpy(q).to(dev), torch.from_numpy(S).to(dev)
    d9, i9 = knn_plain(qt, pt, k=9, q_chunk=8192, p_tile=32768)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(d).all()), "K3 distances finite")
    max_err = float((d - d9[:, :8]).abs().max())
    require(torch.allclose(d, d9[:, :8], rtol=1e-6, atol=0.0),
            "K3 distances match the plain version")
    untied = torch.ones(q.shape[0], 8, dtype=torch.bool, device=dev)
    untied[:, 1:] &= d9[:, 1:8] != d9[:, :7]
    untied &= d9[:, :8] != d9[:, 1:9]
    require(torch.equal(i.long()[untied], i9[:, :8][untied]),
            "K3 indices match wherever the distance is not tied")
    ms = kernel_ms(plan)
    plain_ms = cuda_ms(lambda: knn_plain(qt, pt, k=8, q_chunk=8192,
                                         p_tile=32768), reps=1, warmup=0)
    bound_ms, bound_by = bound(plan)

    vplan = KnnQueryPlan(cm, prep)
    view_ms = kernel_ms(vplan)
    view_bound_ms, _ = bound(vplan)
    log(f"[K3] {q.shape[0]} queries × {M} points: max |kernel − plain| "
        f"{max_err:.3e}, untied {float(untied.float().mean()):.6f}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({plan.pair_count()} pairs); host plan {plan_s:.3f} s")
    log(f"[K3] whole view ({cm.shape[0]} queries): kernel {view_ms:.4f} ms, "
        f"bound {view_bound_ms:.4f} ms ({vplan.pair_count()} pairs, "
        f"{vplan.cand.shape[1]} candidate tiles max)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "queries": q.shape[0], "view_ms": view_ms,
            "view_bound_ms": view_bound_ms}


def nerfail_path(dev, mp):
    """NeRFail on the main path's tables: batched DeepFool through the
    K1/K2 engine, with the reference control plane."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.config import AttackConfig

    cfg = AttackConfig(method="NeRFail", eps=EPS, m1=0.0,
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
    loops = 0
    for h in res.history:
        iters = h["deepfool_iters"]
        require(all(len(b) == BATCH for b in iters)
                and h["deepfool_calls"] <= BATCH * len(iters)
                and (h["deepfool_calls"] == 0) == (not iters),
                f"DeepFool batches of epoch {h['epoch']}")
        loops += sum(max(min(i + 1, DF_MAX_ITER) for i in b) for b in iters)
    log(f"[nerfail] {len(res.history)} epochs, {loops} DeepFool iterations "
        f"in {wall:.3f} s (m1 = {cfg.m1}, m2 = {cfg.m2}, ≤ {DF_MAX_ITER} "
        f"iterations); peak device memory {peak:.3f} GiB")
    require(loops > 0, "NeRFail ran DeepFool")
    d = res.delta
    require(d.shape == mp["delta0"].shape and np.isfinite(d).all(),
            "NeRFail δ shape, finite")
    np.testing.assert_array_equal(d[..., 3], mp["delta0"][..., 3])
    require(np.abs(d[..., :3]).max() <= 255.0, "NeRFail δ clamp")
    return {"res": res, "loops": loops, "wall_s": wall, "peak_gb": peak,
            "cfg": cfg}


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
    as the engine's pick of that iteration. Also the plan that lists only
    touched rows against one that lists every one of the V·M rows."""
    import torch

    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        error_bound, plan_point_ids, segment_sq, segment_sq_plain,
        segment_sum, segment_sum_plain, sq_error_bound,
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
    log(f"[K2] batched plan for {V}×{H}² on the card: {b['plan_ms']:.3f} ms, "
        f"{plan.n_pairs} kept pairs, {plan.n_rows} touched rows of {V * M}; "
        f"Gdiff stack {tuple(G.shape)}")

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
    P, R = plan.n_pairs, plan.n_rows
    kept_pix = int((b["ori"][..., 3] > 0).sum())
    nbytes = 8 * P + 4 * C * kept_pix + 4 * (R + 1) + 4 * (V + 1) + 4 * V * C
    ops = 2 * P * C + 2 * R * C
    bound_ms = max(nbytes / PEAK_BYTES, ops / PEAK_FP32) * 1e3

    # K1 as the engine's pick: each view's class as deepfool_batch
    # chooses it from these logits and norms
    views = torch.arange(V, device=dev)
    sq = k.view(V, N_CLASSES, 4).sum(-1)
    f = logits - logits[views, b["ori_label"]][:, None] - df["cfg"].m2
    value = f.abs() / (sq.sqrt() + 1e-4)
    value[views, b["ori_label"]] = float("inf")
    choice = value.argmin(-1)
    gsel = G.view(V, -1, N_CLASSES, 4)[views, :, choice].reshape(-1, 4)
    pk = segment_sum(gsel, plan)
    pk2 = segment_sum(gsel, plan)
    pref = segment_sum_plain(gsel, plan)
    torch.cuda.synchronize()
    require(torch.equal(pk, pk2), "K1 pick bit-equal across runs")
    perr = (pk - pref).abs()
    require(bool((perr <= error_bound(gsel, plan)).all()),
            "K1 pick within the fp32 sum bound")
    untouched = torch.ones(V * M, dtype=torch.bool, device=dev)
    untouched[plan.rows.long()] = False
    require(bool((pk[untouched] == 0).all()), "K1 pick: untouched rows 0")
    require(bool(torch.isfinite(pk).all()) and float(pk.abs().max()) > 0,
            "K1 pick finite and not all zero")
    pick_max_err = float(perr.max())
    pick_ms = cuda_ms(lambda: segment_sum(gsel, plan), reps=20, warmup=2)
    pick_nbytes = (8 * P + 4 * 4 * kept_pix + 4 * (2 * R + 1)
                   + 4 * 4 * V * M)
    pick_bound_ms = max(pick_nbytes / PEAK_BYTES,
                        2 * P * 4 / PEAK_FP32) * 1e3

    # the plan choice: every row listed (idle lane groups on empty rows)
    # K1 sums each row alone, so it is bit-equal; K2 adds the rows in
    # blocks of another grouping, so it is held to its bound
    full = every_row(plan)
    require(torch.equal(segment_sum(gsel, full), pk),
            "K1 on every row equals K1 on the touched rows")
    require(bool(((segment_sq(G, full) - ref).abs()
                  <= sq_error_bound(G, full)).all()),
            "K2 on every row within sq_error_bound")
    full_ms = cuda_ms(lambda: segment_sq(G, full), reps=20, warmup=2)
    pick_full_ms = cuda_ms(lambda: segment_sum(gsel, full), reps=20,
                           warmup=2)
    log(f"[K2] max |kernel − plain| {max_err:.3e} (≤ sq_error_bound, max "
        f"{float(bound.max()):.3e}; values up to {float(ref.max()):.3e}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ + square "
        f"+ sum {composite_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} "
        f"bytes, {ops} flops)")
    log(f"[K1 pick] classes {choice.tolist()}: max |kernel − plain| "
        f"{pick_max_err:.3e} (values up to {float(pref.abs().max()):.3e}), "
        f"bit-equal across runs, untouched rows 0; {pick_ms:.4f} ms "
        f"(zero-fill included), bound {pick_bound_ms:.4f} ms")
    log(f"[plan] DeepFool, touched rows vs every row: K2 {ms:.4f} vs "
        f"{full_ms:.4f} ms; K1 pick {pick_ms:.4f} vs {pick_full_ms:.4f} ms")
    return ({"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
             "library_ms": None, "composite_ms": composite_ms,
             "bound_ms": bound_ms,
             "bound_by": "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_FP32
             else "operations",
             "n_pairs": P, "n_rows": R, "plan_ms": b["plan_ms"],
             "every_row_ms": full_ms},
            {"pick_max_abs_err": pick_max_err, "pick_ms": pick_ms,
             "pick_bound_ms": pick_bound_ms,
             "pick_every_row_ms": pick_full_ms})


def profile_deepfool(dev, mp, df, M):
    """One DeepFool walk of batch 0 (time per iteration), then one engine
    iteration split by CUDA events (forward and pullbacks, K2, K1 pick)
    and under torch.profiler (device busy share, top kernels)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfail_tpu_torch.attacks.nerfail import make_batched_deepfool
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        segment_sq, segment_sum,
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
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    with torch.no_grad():
        pix = splat_forward_batched(points_b, b["idx"], b["w"])
    logits, G = deepfool_cotangents(b["head"], pix, N_CLASSES,
                                    b["ori_label"])
    ev[1].record()
    segment_sq(G, b["plan"])
    ev[2].record()
    segment_sum(G.view(V, -1, N_CLASSES, 4)[torch.arange(V, device=dev), :,
                                              k].reshape(-1, 4), b["plan"])
    ev[3].record()
    torch.cuda.synchronize()
    split = {"forward_and_pullbacks_ms": ev[0].elapsed_time(ev[1]),
             "k2_ms": ev[1].elapsed_time(ev[2]),
             "pick_ms": ev[2].elapsed_time(ev[3])}
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
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    t0 = time.time()
    K, poses = scene(N_VIEWS, H)
    ori, S = views(K, poses, H)
    require(S.shape[0] == len(MASK_VIEWS) * H * H, "M = 3·800²")
    log(f"[scene] {N_VIEWS} views at {H}², M = {S.shape[0]}: "
        f"{time.time() - t0:.3f} s")

    segment_sum.launches = 0
    knn_sq_cuda.launches = 0
    mp = main_path(dev, K, poses, ori, S)
    launches = {"K1": segment_sum.launches, "K3": knn_sq_cuda.launches}
    log(f"[main path] kernel launches: {launches}")
    n_steps = EPOCHS * -(-N_VIEWS // BATCH)
    require(launches["K1"] == n_steps, f"K1 once per step ({n_steps})")
    require(launches["K3"] == N_VIEWS, f"K3 once per view ({N_VIEWS})")

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
    log(f"[summary] NeRFail path: {df['loops']} DeepFool iterations, "
        f"{dfp['iter_ms']:.3f} ms per iteration (batch 0 walk), peak "
        f"{df['peak_gb']:.3f} GiB; quality (64² / SimpleCNN): val_acc "
        f"{quality['val_acc']:.4f}, NeRFail ASR {quality['NeRFail']['asr']}, "
        f"NeRFail-S ASR {quality['NeRFail-S']['asr']}")

    rows = [
        {"name": "K1 splat-backward segmented sum", "route": "cuda",
         "source": "nerfail_tpu_torch/csrc/segsum.cu",
         "replaces": "nerfail_tpu/ops/pallas/segsum_kernel.py:395",
         "launches": launches["K1"], "nerfail_launches": df_launches["K1"],
         **k1, **pick},
        {"name": "K2 squared norms of the segmented sum", "route": "cuda",
         "source": "nerfail_tpu_torch/csrc/segsum_sq.cu",
         "replaces": "nerfail_tpu/ops/pallas/segsum_kernel.py:436",
         "launches": df_launches["K2"], **k2},
        {"name": "K3 exact 8-NN", "route": "cuda",
         "source": "nerfail_tpu_torch/csrc/knn.cu",
         "replaces": "nerfail_tpu/ops/pallas/knn_kernel.py:44",
         "launches": launches["K3"], **k3},
    ]
    log(json.dumps({"kernels": rows}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
