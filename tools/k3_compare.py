#!/usr/bin/env python3
"""K3 and the 16-view table build of one or more checkouts, on one card.

    python3 tools/k3_compare.py <checkout root> [<checkout root> ...]

For each root in turn (one process each, so two checkouts of the port
never share a process): builds that checkout's `csrc/knn.cu` and prints
nvcc's register and spill counts; makes `chip_smoke.py`'s scene (16 poses
at 800², the point set of 3 mask views, M = 1.92 M); then times
  * the point prep and view 0's plan (host clock, ending in a sync);
  * K3 alone on view 0's plan: mean device time of 3 runs after a warm
    one (CUDA events), and a checksum of its squared distances, which
    every checkout must share (the same f32 arithmetic on the same pairs);
  * the 16-view table build through the checkout's own
    `chip_smoke.tables` (coordinate maps, plan, K3, weights; host clock
    ending in a sync);
  * for a checkout whose plan cuts work items (`plan.work`), the search +
    merge of view 0 at several item sizes;
and prints one `RESULT <root> {json}` line. To compare two commits,
unpack the other into a directory that .gitignore lists
(`git archive <commit> | tar -x -C _proof/parent`) and pass the roots in
turns: parent, change, change, parent. Imports no JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import time


def run_one(root: str) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.ops.cuda import build
    from nerfail_tpu_torch.ops.cuda import knn_kernel as kk

    t0 = time.time()
    logs = build.build_all(("knn",))
    print(f"[{root}] build {time.time() - t0:.1f} s", flush=True)
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[ptxas] {line.strip()}", flush=True)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    K, poses = cs.scene(cs.N_VIEWS, cs.H)
    S = np.concatenate([analytic_coord_map(poses[v], cs.H, cs.H, K)
                        .reshape(-1, 3) for v in cs.MASK_VIEWS])
    cm = analytic_coord_map(poses[0], cs.H, cs.H, K).reshape(-1, 3)

    torch.cuda.synchronize()
    t0 = time.time()
    prep = kk.KnnPrep(S, device=dev)
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    t0 = time.time()
    plan = kk.KnnQueryPlan(cm, prep)
    torch.cuda.synchronize()
    plan_s = time.time() - t0
    res = {"prep_s": prep_s, "plan_s": plan_s,
           "pairs": plan.pair_count()}
    if hasattr(plan, "cand"):      # host-planned, one block per query tile
        qpk = torch.from_numpy(plan.qpk).to(dev)
        cand = torch.from_numpy(plan.cand).to(dev)

        def k3():
            return kk.knn_sq_cuda(qpk, prep.ppk, cand, prep.M)
    else:
        work = plan.work()

        def k3():
            return kk.knn_sq_cuda(plan.qpk, prep.ppk, plan.tiles, work,
                                  prep.M)
    d2, _ = k3()
    torch.cuda.synchronize()
    res["d2_sha256"] = hashlib.sha256(
        d2[:plan.Q].cpu().numpy().tobytes()).hexdigest()[:16]
    res["k3_ms"] = cs.cuda_ms(k3, reps=3)
    if hasattr(plan, "work"):
        res["item_ms"] = {}
        for c in (8, 16, 32, 64, 128, plan.max_c()):
            w = plan.work(c)
            res["item_ms"][c] = cs.cuda_ms(
                lambda: kk.knn_sq_cuda(plan.qpk, prep.ppk, plan.tiles, w,
                                       prep.M), reps=3)
    torch.cuda.synchronize()
    t0 = time.time()
    cs.tables(K, poses, S, cs.H, dev, prep=prep)
    torch.cuda.synchronize()
    res["tables_s"] = time.time() - t0
    res["tables_s_per_view"] = res["tables_s"] / cs.N_VIEWS
    print("RESULT", root, json.dumps(res), flush=True)


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
