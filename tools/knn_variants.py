#!/usr/bin/env python3
"""Variants of csrc/knn.cu against the source as built, on one card.

    python3 tools/knn_variants.py

Run from the repository root. Each variant is the source with a few
lines replaced, built with the same nvcc flags into `_proof/variants/`
(listed in .gitignore). On view 0 of `chip_smoke.py` (800², M = 1.92 M,
the plan on the card), each variant's search + merge is timed with CUDA
events at several work-item sizes, twice in turns, and its output is
compared with the source as built at the default item size: every
variant computes the same thing, so all must be bit-equal.
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import nerfail_tpu_torch.ops.cuda.knn_kernel as kk  # noqa: E402
from nerfail_tpu_torch.data.synthetic import analytic_coord_map  # noqa: E402
from nerfail_tpu_torch.ops.cuda import build  # noqa: E402

OUT = "_proof/variants"
QPT = "constexpr int QPT = 2;"
UNROLL = "#pragma unroll 4\n    for (int l = 0; l < n; ++l) {"
STAGES = "constexpr int STAGES = 3;"
BOUNDS = "__global__ void __launch_bounds__(THREADS)\nknn_search_kernel"

VARIANTS = {
    "as built": [],
    "1 query a thread": [(QPT, QPT.replace("2", "1"))],
    "4 queries a thread": [(QPT, QPT.replace("2", "4"))],
    "4 queries a thread, unroll 2": [(QPT, QPT.replace("2", "4")),
                                     (UNROLL, UNROLL.replace("4", "2"))],
    "unroll 8": [(UNROLL, UNROLL.replace("4", "8"))],
    "2 stages": [(STAGES, STAGES.replace("3", "2"))],
    "≥ 8 blocks an SM": [(BOUNDS, BOUNDS.replace("(THREADS)",
                                                 "(THREADS, 8)"))],
}
ITEM_TILES = (32, 64, 128)


def build_variants(src: str):
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name!r}: source line not found")
            s = s.replace(old, new)
        cu, so = f"{OUT}/k{i}.cu", os.path.abspath(f"{OUT}/libk{i}.so")
        with open(cu, "w") as f:
            f.write(s)
        jobs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        for line in log.splitlines():
            if "knn_search" in line or "registers" in line:
                print(f"[{name}] {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(build.CSRC, "knn.cu")) as f:
        libs = build_variants(f.read())
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    K, poses = cs.scene(cs.N_VIEWS, cs.H)
    S = np.concatenate([analytic_coord_map(poses[v], cs.H, cs.H, K)
                        .reshape(-1, 3) for v in cs.MASK_VIEWS])
    prep = kk.KnnPrep(S, device=dev)
    plan = kk.KnnQueryPlan(analytic_coord_map(poses[0], cs.H, cs.H, K), prep)
    works = {c: plan.work(c) for c in ITEM_TILES}
    load = build.load
    ref = None
    for rnd in range(2):
        for name, lib in libs.items():
            build.load = lambda _name, lib=lib: lib
            out = kk.knn_sq_cuda(plan.qpk, prep.ppk, plan.tiles,
                                 works[kk.ITEM_TILES], prep.M)
            torch.cuda.synchronize()
            if ref is None:
                ref = out
            same = torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
            ms = {c: cs.cuda_ms(lambda w=w: kk.knn_sq_cuda(
                plan.qpk, prep.ppk, plan.tiles, w, prep.M), reps=3)
                for c, w in works.items()}
            print(f"round {rnd} [{name}] search + merge, ms by tiles an "
                  f"item: " + ", ".join(f"{c}: {v:.4f}" for c, v in ms.items())
                  + f"; bit-equal to as built: {same}", flush=True)
    build.load = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
