#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerfail_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of the repository. It needs one CUDA device and nvcc,
and exits non-zero without a result line when either is missing.

1. builds both CUDA kernels from nerfail_tpu_torch/csrc (one nvcc each, in
   parallel);
2. drives the port's main path at full width, through its entry points,
   with every kernel launch counter set to 0 just before and read just
   after: 16 views of the box scene at 800², a point set of 3·800² =
   1.92 M points from 3 mask views, the 8-NN tables by K3
   (build_index_and_dist) and their Gaussian weights, NeRFail-S
   (ε = 32, a = 2, batch 8, 2 epochs: 4 steps, each through K1) against
   Inception-V3 at 299² with 8 classes from a seeded random init, and
   evaluate_attack on the result. The init is random because the repo
   holds no trained weights: the ASR it prints is not an attack result;
3. checks what came out: shapes, finite values, the ε-ball, exact
   self-distances, and a 32² run whose CUDA path must agree with the
   port's CPU path (the plain versions, held against JAX by the tests);
4. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes, times kernel, plain version and library call,
   and computes each kernel's bound from this run's inputs;
5. profiles one steady attack step (device busy share, top kernels).

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
        f"{plan.n_pairs} kept pairs of {idx.numel()}")

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
    P, C = plan.n_pairs, 4
    kept_pix = int(mask.sum())
    nbytes = 8 * P + 4 * C * kept_pix + 4 * (M + 1) + 4 * C * M
    bound_ms = max(nbytes / PEAK_BYTES, 2 * P * C / PEAK_FP32) * 1e3
    log(f"[K1] max |kernel − plain| {max_err:.3e} (≤ per-entry fp32 bound "
        f"max {float(bound.max()):.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({nbytes} bytes)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / PEAK_BYTES
            >= 2 * P * C / PEAK_FP32 else "operations",
            "n_pairs": P, "plan_ms": plan_ms}


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
        from nerfail_tpu_torch.ops.cuda.segsum_kernel import segment_sum
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

    check_outputs(mp, S)
    small_cuda_vs_cpu(dev)
    k1 = k1_phase(dev, mp, S.shape[0])
    k3 = k3_phase(dev, mp, K, poses, S)
    profile_step(dev, mp, S.shape[0])

    rows = [
        {"name": "K1 splat-backward segmented sum", "route": "cuda",
         "source": "nerfail_tpu_torch/csrc/segsum.cu",
         "replaces": "nerfail_tpu/ops/pallas/segsum_kernel.py:395",
         "launches": launches["K1"], **k1},
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
