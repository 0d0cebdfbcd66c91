#!/usr/bin/env python3
"""K2, the K1 DeepFool pick and the NeRFail-S K1 of one or more
checkouts, on one card.

    python3 tools/k12_compare.py <checkout root> [<checkout root> ...]

For each root in turn (one process each, so two checkouts of the port
never share a process): builds that checkout's `csrc/segsum.cu` and
`csrc/segsum_sq.cu` and prints ptxas's register and spill counts; makes
batch 0 of `chip_smoke.py`'s attack (8 of its 16 poses at 800², the point
set of 3 mask views, M = 1.92 M, the 8-NN tables by K3, background pairs
dropped) with that checkout's own plan builders; then times, by CUDA
events (mean of 20 runs after 2 warm ones):
  * K2 on a seeded [8·800², 32] class stack over the batched plan;
  * the pick as the DeepFool engine runs it: `splat_deepfool_engine`
    with a seeded linear head (its class stack is the head's weights),
    then `pick(k)` alone, which on a checkout without the in-place pick
    includes the copy of each view's class out of the stack;
  * K1 over the one-view plan of NeRFail-S, on a seeded [8·800², 4]
    cotangent;
and, by the host clock over calls that each end in a sync (median of 5
after 2 warm ones), one NeRFail-S step (`make_nerfail_s_step`) and one
DeepFool engine iteration with its pick, both through a seeded random
Inception-V3 at 299² as in `chip_smoke.py`; it prints one `RESULT <root>
{json}` line with the times, the plan build times (host clock ending in
a sync) and a checksum of each output. K1's
checksums (pick and NeRFail-S) must match across checkouts: the same rows
summed in the same per-row order. K2's need not: its tree of squares is
the kernel's own. To compare two commits, unpack the other into a
directory that .gitignore lists (`git archive <commit> | tar -x -C
_proof/parent`) and pass the roots in turns: parent, change, change,
parent. Imports no JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

N_CLASSES = 8


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def inputs(cs, dev):
    """Batch 0 of chip_smoke's attack: tables, mask and the point count,
    through the checkout's own chip_smoke (the same seed in every one)."""
    import torch

    from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep

    K, poses = cs.scene(cs.N_VIEWS, cs.H)
    poses = poses[:cs.BATCH]
    ori, S = cs.views(K, poses, cs.H)
    weights, idx, _ = cs.tables(K, poses, S, cs.H, dev,
                                prep=KnnPrep(S, device=dev))
    ori_u8 = torch.from_numpy(ori).to(dev)
    return {"w": weights, "idx": idx, "mask": ori_u8[..., 3:] > 0,
            "ori": ori_u8, "M": S.shape[0], "V": cs.BATCH}


def stack(d, dev, C):
    """A seeded [V·H·W, C] f32 tensor on the card."""
    import torch

    gen = torch.Generator().manual_seed(C)
    n = d["idx"][..., 0].numel()
    return torch.randn(n, C, generator=gen).to(dev)


def run_one(root: str) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from nerfail_tpu_torch.ops.cuda import build
    from nerfail_tpu_torch.ops.cuda import segsum_kernel as sk
    from nerfail_tpu_torch.ops.splat import splat_deepfool_engine

    t0 = time.time()
    logs = build.build_all(("segsum", "segsum_sq"))
    print(f"[{root}] build {time.time() - t0:.1f} s", flush=True)
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[ptxas] {line.strip()}", flush=True)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    d = inputs(cs, dev)
    V, M = d["V"], d["M"]
    res = {}

    torch.cuda.synchronize()
    t0 = time.time()
    plan = sk.build_batched_csr_plan(d["idx"], d["w"], M,
                                     pair_mask=d["mask"])
    torch.cuda.synchronize()
    res["batched_plan_ms"] = (time.time() - t0) * 1e3
    res["n_pairs"], res["n_rows"] = plan.n_pairs, plan.n_rows
    G = stack(d, dev, 4 * N_CLASSES)
    res["k2_sha"] = digest(sk.segment_sq(G, plan))
    res["k2_ms"] = cs.cuda_ms(lambda: sk.segment_sq(G, plan), reps=20,
                              warmup=2)

    # the engine's pick: a linear head whose class stack is Wc itself
    gen = torch.Generator().manual_seed(1)
    Wc = torch.randn(N_CLASSES, V, cs.H, cs.H, 4, generator=gen).to(dev)
    pts = torch.randn(V, M, 4, generator=gen).to(dev)

    def head(pix):
        return torch.einsum("vhwc,kvhwc->vk", pix, Wc)

    ori_label = torch.arange(V, device=dev) % N_CLASSES
    k = (ori_label + 1 + torch.arange(V, device=dev) // 2) % N_CLASSES
    _, _, pick = splat_deepfool_engine(head, pts, d["idx"], d["w"], plan,
                                       N_CLASSES, ori_label)
    res["pick_sha"] = digest(pick(k))
    res["pick_ms"] = cs.cuda_ms(lambda: pick(k), reps=20, warmup=2)
    del pick, Wc, pts

    torch.cuda.synchronize()
    t0 = time.time()
    plan1 = sk.build_csr_plan(d["idx"], d["w"], M, pair_mask=d["mask"])
    torch.cuda.synchronize()
    res["shared_plan_ms"] = (time.time() - t0) * 1e3
    g = stack(d, dev, 4)
    res["k1_sha"] = digest(sk.segment_sum(g, plan1))
    res["k1_ms"] = cs.cuda_ms(lambda: sk.segment_sum(g, plan1), reps=20,
                              warmup=2)
    res.update(end_to_end(cs, dev, d, plan, plan1))
    print("RESULT", root, json.dumps(res), flush=True)


def host_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median wall time of fn() by the host clock, each call ending in a
    sync."""
    import torch

    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def end_to_end(cs, dev, d, plan, plan1):
    """One NeRFail-S step and one DeepFool engine iteration (forward, the
    class pullbacks, K2, the pick) on batch 0, through Inception-V3."""
    import numpy as np
    import torch

    from nerfail_tpu_torch.attacks.forward import (
        composite_after_splat, make_classifier_logits_fn, resize_batch,
        zero_init_mask,
    )
    from nerfail_tpu_torch.attacks.nerfail_s import make_nerfail_s_step
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.models.classifiers.inception_v3 import InceptionV3
    from nerfail_tpu_torch.ops.splat import splat_deepfool_engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(cs.SEED)
    logits_fn = make_classifier_logits_fn(
        InceptionV3(num_classes=N_CLASSES).to(dev))
    V, M = d["V"], d["M"]
    ori_np = d["ori"][list(cs.MASK_VIEWS)].cpu().numpy().astype(np.float32)
    delta0 = zero_init_mask(ori_np).to(dev)
    step = make_nerfail_s_step(
        logits_fn, AttackConfig(eps=cs.EPS, a=cs.STEP_A, batch_size=V),
        cs.RESIZE)
    batch = (d["w"], d["idx"], d["ori"],
             torch.zeros(V, dtype=torch.int64, device=dev),
             torch.ones(V, device=dev), plan1)
    out = {"nerfail_s_step_ms": host_ms(
        lambda: step(delta0, delta0, *batch))}
    ori = d["ori"].to(torch.float32)

    def head(pix):
        x = composite_after_splat(pix, ori, eps=cs.EPS)["cla_x"]
        return logits_fn(resize_batch(x, cs.RESIZE))

    points_b = delta0.reshape(1, M, 4).expand(V, M, 4).contiguous()
    ori_label = torch.zeros(V, dtype=torch.int64, device=dev)
    k = torch.ones(V, dtype=torch.int64, device=dev)

    def iteration():
        _, _, pick = splat_deepfool_engine(head, points_b, d["idx"], d["w"],
                                           plan, N_CLASSES, ori_label)
        pick(k)

    out["deepfool_iteration_ms"] = host_ms(iteration, reps=3)
    return out


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
