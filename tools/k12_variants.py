#!/usr/bin/env python3
"""Variants of csrc/segsum_sq.cu (K2) and csrc/segsum.cu (K1) against the
sources as built, on one card.

    python3 tools/k12_variants.py

Run from the repository root. Each variant is a source with its tuning
constants replaced, built with the same nvcc flags into
`_proof/variants/` (listed in .gitignore). On batch 0 of `chip_smoke.py`'s
attack (tools/k12_compare.py's inputs: 8 views at 800², M = 1.92 M, a
seeded 32-channel class stack), each variant is timed by CUDA events
in the plans' plan-row order and in the Morton order of each row's first
pixel (`chip_smoke.morton`, from `tools/segsum_order.py`), twice in
turns:
K2 on the stack; K1 as the DeepFool pick (one class per view, read in
place) and as the NeRFail-S backward. K1 variants must be bit-equal to
the source as built; K2 variants that keep the tree of squares
(ROWS_PER_GROUP) bit-equal too, the others within sq_error_bound. The
diagnostic variants change what is gathered (every gather through L2
only, or from a few rows of g that stay in L1): they compute other sums
and show where the time goes.
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import k12_compare  # noqa: E402
from nerfail_tpu_torch.ops.cuda import build  # noqa: E402
from nerfail_tpu_torch.ops.cuda import segsum_kernel as sk  # noqa: E402

OUT = "_proof/variants"
RI2 = "constexpr int RI = 2;"
U2 = "constexpr int U = 2;"
RPG8 = "constexpr int ROWS_PER_GROUP = 8;"
LANES4 = "constexpr int GROUP = 4;"
GATHER = "gv[i][u][k] = __ldg(gr + k);"

# source substitutions, and the wrapper's SQ_* constants that mirror them
K2_VARIANTS = {
    "as built": ([], {}),
    "RI 4": ([(RI2, "constexpr int RI = 4;")], {}),
    "U 1": ([(U2, "constexpr int U = 1;")], {}),
    "rows a group 16": ([(RPG8, "constexpr int ROWS_PER_GROUP = 16;")],
                        {"SQ_ROWS_PER_GROUP": 16}),
    "8 lanes a row": ([(LANES4, "constexpr int GROUP = 8;")],
                      {"SQ_GROUPS": 32}),
    "2 lanes a row": ([(LANES4, "constexpr int GROUP = 2;")],
                      {"SQ_GROUPS": 128}),
    "2 lanes a row, RI 1": ([(LANES4, "constexpr int GROUP = 2;"),
                             (RI2, "constexpr int RI = 1;")],
                            {"SQ_GROUPS": 128}),
    "RI 1": ([(RI2, "constexpr int RI = 1;")], {}),
    "8 lanes a row, RI 4": ([(LANES4, "constexpr int GROUP = 8;"),
                             (RI2, "constexpr int RI = 4;")],
                            {"SQ_GROUPS": 32}),
    "gathers through L2 only": ([(GATHER, GATHER.replace("__ldg",
                                                          "__ldcg"))], {}),
    # diagnostics (not the same sums): where the time goes
    "gathers from 256 rows": ([(GATHER, GATHER.replace(
        "gr + k", "g + (px[i][u] & 255) * Q + quad + k"))], {}),
    "one row gathered": ([(GATHER, GATHER.replace(
        "gr + k", "g + quad + k"))], {}),
}
K1_VARIANTS = {
    "as built": [],
    "gathers through L2 only": [(
        "const float4 gv = __ldg(gc + __ldg(pix + p) * stride4);",
        "const float4 gv = __ldcg(gc + __ldg(pix + p) * stride4);")],
}


def build_variants(name: str, variants):
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
        src = f.read()
    jobs = {}
    for i, (vname, subs) in enumerate(variants.items()):
        if isinstance(subs, tuple):
            subs = subs[0]
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"{name} variant {vname!r}: source line "
                                   "not found")
            s = s.replace(old, new)
        cu, so = f"{OUT}/{name}{i}.cu", os.path.abspath(f"{OUT}/lib{name}{i}.so")
        with open(cu, "w") as f:
            f.write(s)
        jobs[vname] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for vname, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} variant {vname!r} failed to build:\n"
                               f"{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}: {vname}] {line.strip()}", flush=True)
        libs[vname] = ctypes.CDLL(so)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    k2_libs = build_variants("segsum_sq", K2_VARIANTS)
    k1_libs = build_variants("segsum", K1_VARIANTS)
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    d = k12_compare.inputs(cs, dev)
    V, M = d["V"], d["M"]
    plan = sk.build_batched_csr_plan(d["idx"], d["w"], M,
                                     pair_mask=d["mask"])
    plan1 = sk.build_csr_plan(d["idx"], d["w"], M, pair_mask=d["mask"])
    zorder = {id(p): cs.morton(p) for p in (plan, plan1)}
    G = k12_compare.stack(d, dev, 4 * k12_compare.N_CLASSES)
    g = k12_compare.stack(d, dev, 4)
    cls = (torch.arange(V, device=dev) * 3 + 1) % k12_compare.N_CLASSES
    ref = sk.segment_sq_plain(G, plan)
    print(f"batched plan: {plan.n_pairs} pairs, {plan.n_rows} rows; "
          f"shared plan: {plan1.n_rows} rows", flush=True)
    load = build.load
    base = {}
    for rnd in range(2):
        for vname, lib in k2_libs.items():
            build.load = (lambda name, lib=lib:
                          lib if name == "segsum_sq" else load(name))
            saved = {k: getattr(sk, k) for k in K2_VARIANTS[vname][1]}
            for k, val in K2_VARIANTS[vname][1].items():
                setattr(sk, k, val)
            sk.SQ_ROWS_PER_BLOCK = sk.SQ_GROUPS * sk.SQ_ROWS_PER_GROUP
            out = sk.segment_sq(G, plan)
            torch.cuda.synchronize()
            base.setdefault("k2", out)
            same = torch.equal(out, base["k2"])
            within = bool(((out - ref).abs()
                           <= sk.sq_error_bound(G, plan)).all())
            ms = cs.cuda_ms(lambda: sk.segment_sq(G, plan), reps=20, warmup=2)
            ms0 = cs.cuda_ms(lambda: sk.segment_sq(G, zorder[id(plan)]),
                             reps=20, warmup=2)
            for k, val in saved.items():
                setattr(sk, k, val)
            sk.SQ_ROWS_PER_BLOCK = sk.SQ_GROUPS * sk.SQ_ROWS_PER_GROUP
            print(f"round {rnd} K2 [{vname}] {ms:.4f} ms, Morton order "
                  f"{ms0:.4f} ms; bit-equal to as built: {same}; within "
                  f"sq_error_bound: {within}", flush=True)
        for vname, lib in k1_libs.items():
            build.load = (lambda name, lib=lib:
                          lib if name == "segsum" else load(name))
            pk = sk.segment_sum_class(G, cls, plan)
            k1 = sk.segment_sum(g, plan1)
            torch.cuda.synchronize()
            base.setdefault("pick", pk)
            base.setdefault("k1", k1)
            same = (torch.equal(pk, base["pick"])
                    and torch.equal(k1, base["k1"]))
            t = {
                "pick": cs.cuda_ms(lambda: sk.segment_sum_class(G, cls, plan),
                                   reps=20, warmup=2),
                "pick, Morton order": cs.cuda_ms(
                    lambda: sk.segment_sum_class(G, cls, zorder[id(plan)]),
                    reps=20, warmup=2),
                "NeRFail-S": cs.cuda_ms(lambda: sk.segment_sum(g, plan1),
                                        reps=20, warmup=2),
                "NeRFail-S, Morton order": cs.cuda_ms(
                    lambda: sk.segment_sum(g, zorder[id(plan1)]),
                    reps=20, warmup=2),
            }
            print(f"round {rnd} K1 [{vname}] " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in t.items())
                + f"; bit-equal to as built: {same}", flush=True)
    build.load = load
    # the zero-fill alone, the part of the pick that every variant shares
    z = cs.cuda_ms(lambda: torch.zeros(V * M, 4, device=dev), reps=20,
                   warmup=2)
    print(f"zero-fill of the pick's [{V * M}, 4] output: {z:.4f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
