#!/usr/bin/env python3
"""The port's full-resolution trained-classifier ASR run on one card:
tools/asr_demo.py in PyTorch, importing no JAX.

    python3 tools/torch_asr_demo.py                    # 60 views
    python3 tools/torch_asr_demo.py n_views=16 out=report_16.json

1. the 800² neighbour tables of n_views views of box class 0 by K3
   (build_index_and_dist on the card), the point set S from mask views
   0-2 (M = 1.92 M), Gaussian weights with c = 0.02;
2. Inception-V3 trained on the 8 box classes through the attack's resize
   (eval/asr_800.py);
3. NeRFail against class 0 with the TPU run's settings
   (tools/asr_demo_report.json): ε = 32, m1 = 8, m2 = 1000, DeepFool
   ≤ 50 iterations, view batch 4, 3 epochs;
4. the acceptance pass (model_test.py:359-377) over every view with the
   best tensor: evaluate_attack with the classifier at 299² (ASR, clean
   accuracy) and the perturbation stats of the white-composited 800²
   views.

Exits non-zero below clean accuracy 0.8 or ASR 0.9, the bars of
tools/asr_demo.py, after writing its report (tools/torch_asr_demo_report.json
unless out= names another path) with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPORT = os.path.join(ROOT, "tools", "torch_asr_demo_report.json")
MASK_VIEWS = (0, 1, 2)
GAUSS_C = 0.02                 # reference c at 800² (GaussNet.py:79)
EPS = 32.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(n_views=60, epochs=3, view_batch=4, df_max_iter=50, out=REPORT):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_asr_demo: needs a CUDA device")
    from nerfail_tpu_torch.attacks.forward import (
        make_classifier_logits_fn, resize_batch, splat_attack_forward,
        white_composite_255, zero_init_mask,
    )
    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.eval import asr_800
    from nerfail_tpu_torch.eval.harness import evaluate_attack
    from nerfail_tpu_torch.ops.cuda import build
    from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
    from nerfail_tpu_torch.pointset.weights import gauss_weights

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    H, R = asr_800.H, asr_800.RESIZE
    report = {"method": "nerfail", "n_views": n_views, "H": H,
              "epochs": epochs, "view_batch": view_batch,
              "df_max_iter": df_max_iter, "eps": EPS, "card": card_line(),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[demo] {report['card']}")
    t0 = time.time()
    build.build_all()
    report["build_s"] = time.time() - t0

    # 1. tables
    t0 = time.time()
    K, poses = asr_800.attack_scene(n_views, H)
    ori, S = asr_800.attack_views(K, poses, H, MASK_VIEWS)
    report["M"] = int(S.shape[0])
    prep = KnnPrep(S, device=dev)
    ws, ids = [], []
    for v in range(n_views):
        d, i = build_index_and_dist(analytic_coord_map(poses[v], H, H, K),
                                    S, method="device", device=dev,
                                    prep=prep)
        ws.append(gauss_weights(d, c=GAUSS_C))
        ids.append(i)
    weights, idx = torch.stack(ws), torch.stack(ids)
    del prep, ws, ids
    torch.cuda.synchronize()
    report["table_build_s"] = time.time() - t0
    log(f"[demo] tables of {n_views} views at {H}², M = {report['M']}: "
        f"{report['table_build_s']:.3f} s (scene render included)")

    # 2. classifier
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.time()
    data = asr_800.class_data(device=dev)
    model, info = asr_800.train_inception(
        data, device=dev,
        log_fn=lambda e, m: log(f"[classifier] epoch {e}: {json.dumps(m)}"))
    torch.backends.cudnn.deterministic = False
    report["classifier"] = {
        "val_acc": info["val_acc"], "best_epoch": info["best_epoch"],
        "epochs": info["epochs"], "train_s": info["train_s"],
        "with_data_s": time.time() - t0}
    log(f"[demo] classifier: {json.dumps(report['classifier'])}")
    logits_fn = make_classifier_logits_fn(model)

    # 3. attack
    ori_d = torch.from_numpy(ori).to(dev)
    delta0 = zero_init_mask(ori[list(MASK_VIEWS)].astype(np.float32)).numpy()
    cfg = AttackConfig(method="NeRFail", eps=EPS, m1=8.0, m2=1000.0,
                       df_max_iter=df_max_iter, view_batch=view_batch,
                       attack_epochs=epochs)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = nerfail_attack(
        delta0, weights, idx, ori_d, logits_fn, cfg, resize_to=R,
        epochs=epochs, device=dev,
        log_fn=lambda e, m: log(f"[attack] epoch {e}: {json.dumps(m)}"))
    torch.cuda.synchronize()
    report["attack_total_s"] = time.time() - t0
    report["epoch_log"] = res.history
    report["best_attack_acc"] = res.best_attack_acc

    # 4. acceptance pass over every view with the best tensor
    t0 = time.time()
    delta = torch.from_numpy(res.delta).to(dev).reshape(-1, 4)
    attacked, clean = [], []
    with torch.no_grad():
        for s in range(0, n_views, 8):
            o = splat_attack_forward(delta, weights[s:s + 8], idx[s:s + 8],
                                     ori_d[s:s + 8], logits_fn, eps=EPS,
                                     resize_to=R, device=dev)
            rgba = o["attacked_rgba"]
            attacked.append(white_composite_255(rgba[..., :3],
                                                rgba[..., 3:]).cpu())
            c = ori_d[s:s + 8].float()
            clean.append(white_composite_255(c[..., :3], c[..., 3:]).cpu())
    rep = evaluate_attack(lambda x: logits_fn(resize_batch(x, R)),
                          torch.cat(attacked).numpy(),
                          torch.cat(clean).numpy(), true_label=0,
                          batch_size=8, device=dev)
    report["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    report["eval_s"] = time.time() - t0
    report["final_eval"] = rep
    report["card_after"] = card_line()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    log(f"[demo] clean_acc={rep['clean_acc_target_class']:.4f} "
        f"asr={rep['asr']:.4f} e_max={rep['e_max']:.4f} "
        f"psnr_avg={rep['psnr_avg']:.4f} dB; tables "
        f"{report['table_build_s']:.3f} s, attack "
        f"{report['attack_total_s']:.3f} s, peak {report['peak_gb']:.3f} "
        f"GiB; {report['card']}")
    if rep["clean_acc_target_class"] < 0.8:
        sys.exit(f"classifier too weak: clean_acc="
                 f"{rep['clean_acc_target_class']}")
    if rep["asr"] < 0.9:
        sys.exit(f"attack failed: asr={rep['asr']}")
    log("[demo] PASS")


if __name__ == "__main__":
    kw = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kw[k] = v if k == "out" else int(v)
    main(**kw)
