#!/usr/bin/env python3
"""The three step metrics of `chip_smoke.py` from checkouts of the port.

    python3 nerfail_tpu_torch/tools/path_compare.py <root> [<root> ...]

For each root in turn (one process each, so two checkouts never share a
process): builds that checkout's kernels, then measures on the card
  - the NeRF train step: its `chip_smoke.nerf_train_path` (full width,
    30 steps on the 800² box scene; median host time of steps 11-30, each
    ending in a sync);
  - the NeRFail-S step: 16 views at 800², K3 tables from 3 mask views,
    a seeded (untrained) Inception-V3 at 299², batch 8, 2 epochs; the
    second epoch's wall time over its 2 steps, as `main_path` reports it;
  - the DeepFool iteration: batch 0's planned engine walk (m1 8, m2 1000,
    every view counted), its wall time over its iterations;
and prints one `RESULT <root> {json}` line. The metrics that the smoke
takes against a trained classifier are timed here on an untrained one of
the same shape: the work per step and per iteration does not depend on
the weights. To compare two commits on one card, unpack the other into a
directory that .gitignore lists (`git archive <commit> | tar -x -C
_proof/parent`) and pass the roots in turns: parent, change, change,
parent.
"""

import json
import os
import subprocess
import sys
import time

DF_ITERS = 20


def run_one(root: str) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from nerfail_tpu_torch.attacks.forward import (
        make_classifier_logits_fn, zero_init_mask,
    )
    from nerfail_tpu_torch.attacks.nerfail import make_batched_deepfool
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.models.classifiers.inception_v3 import InceptionV3
    from nerfail_tpu_torch.ops.cuda import build
    from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep

    t0 = time.time()
    build.build_all()
    print(f"[{root}] build {time.time() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)

    out = {"nerf_step_ms": cs.nerf_train_path(dev)["steady_ms"]}

    K, poses = cs.scene(cs.N_VIEWS, cs.H)
    ori, S = cs.views(K, poses, cs.H)
    w, idx, _ = cs.tables(K, poses, S, cs.H, dev,
                          prep=KnnPrep(S, device=dev))
    torch.manual_seed(0)
    logits_fn = make_classifier_logits_fn(
        InceptionV3(num_classes=cs.N_CLASSES).to(dev))
    ori_d = torch.from_numpy(ori).to(dev)
    delta0 = zero_init_mask(ori[list(cs.MASK_VIEWS)].astype(np.float32))
    delta0 = delta0.numpy()
    cfg = AttackConfig(method="NeRFail_S", eps=cs.EPS, a=cs.STEP_A,
                       batch_size=cs.BATCH)
    res = nerfail_s_attack(delta0, w, idx, ori_d,
                           np.zeros(cs.N_VIEWS, np.int64), logits_fn, cfg,
                           resize_to=cs.RESIZE, epochs=2, device=dev)
    out["nerfail_s_step_ms"] = (res.history[-1]["time_s"]
                                / -(-cs.N_VIEWS // cs.BATCH) * 1e3)

    mp = {"weights": w, "idx": idx, "ori_d": ori_d, "logits_fn": logits_fn}
    delta = torch.from_numpy(delta0).to(dev)
    b = cs._deepfool_batch0(dev, mp, delta, S.shape[0])
    dcfg = AttackConfig(method="NeRFail", eps=cs.EPS, m2=cs.DF_M2,
                        df_max_iter=DF_ITERS, view_batch=cs.BATCH)
    df_batch = make_batched_deepfool(logits_fn, dcfg, cs.RESIZE,
                                     cs.N_CLASSES,
                                     accumulate_incomplete=True)
    torch.cuda.synchronize()
    t0 = time.time()
    _, iters, _, _ = df_batch(
        delta, b["w"], b["idx"], b["ori"], b["ori_logits"],
        torch.ones(cs.BATCH, dtype=torch.bool, device=dev), dcfg.m1,
        dcfg.m2, b["plan"])
    torch.cuda.synchronize()
    loops = int(torch.clamp(iters + 1, max=DF_ITERS).max())
    out["deepfool_iter_ms"] = (time.time() - t0) / loops * 1e3
    out["deepfool_iters"] = loops
    print("RESULT", root, json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(os.path.abspath(sys.argv[2]))
        return 0
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
