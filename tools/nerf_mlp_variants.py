#!/usr/bin/env python3
"""Variants of csrc/nerf_mlp.cu against the source as built, on one card.

    python3 tools/nerf_mlp_variants.py

Run from the repository root. Each variant is the source with a few
lines replaced (or a wrapper setting changed), built with the same nvcc
flags into `_proof/variants/` (listed in .gitignore). At a full-width train
step's 262 144 points (8×256, the inputs of `chip_smoke.k45_phase`), each
variant's K4, K5a and K5b are timed with CUDA events, twice in turns, and
K5's dW is compared with the source as built. Variants that skip work
(`no stash copies`) measure what that work costs, and give wrong dW; the
others change only the order of the dW sums, or nothing.
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import nerfail_tpu_torch.ops.cuda.mlp_kernel as mk  # noqa: E402
from nerfail_tpu_torch.config import NeRFModelConfig  # noqa: E402
from nerfail_tpu_torch.models.nerf import init_nerf_params  # noqa: E402
from nerfail_tpu_torch.ops.cuda import build  # noqa: E402

OUT = "_proof/variants"

STORE = ("    __stcs(reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * ldd + c),\n"
         "           *reinterpret_cast<const uint4*>(src + r * lds + c));")
PLAIN_STORE = ("    *reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * ldd + c) =\n"
               "        *reinterpret_cast<const uint4*>(src + r * lds + c);")

# name: (source replacements, K5a blocks per SM, K5b waves, K5b tile rows)
ROWS, WAVES = mk.WGRAD_ROWS, mk.WGRAD_WAVES
VARIANTS = {
    "as built": ([], 2, WAVES, ROWS),
    "plain stash stores": ([(STORE, PLAIN_STORE)], 2, WAVES, ROWS),
    "no stash copies": ([("  const int v = cols / 8;\n",
                          "  const int v = cols / 8;\n  if (v > 0) return;\n")],
                        2, WAVES, ROWS),
    "K5a one block per SM": ([], 1, WAVES, ROWS),
    "K5b 64-row tiles": ([("constexpr int BM = 128;", "constexpr int BM = 64;")],
                         2, WAVES, 64),
    "K5b 64-point slices, 2 stages": ([("constexpr int KC = 32;", "constexpr int KC = 64;"),
                                       ("constexpr int STAGES = 4;",
                                        "constexpr int STAGES = 2;")], 2, WAVES, ROWS),
    "K5b twice the splits": ([], 2, 2 * WAVES, ROWS),
}


def build_variants(src: str):
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for i, (name, (subs, _, _, _)) in enumerate(VARIANTS.items()):
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name!r}: source line not found")
            s = s.replace(old, new)
        cu, so = f"{OUT}/v{i}.cu", os.path.abspath(f"{OUT}/libv{i}.so")
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
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(build.CSRC, "nerf_mlp.cu")) as f:
        libs = build_variants(f.read())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    n = cs.K45_POINTS
    cfg = NeRFModelConfig()
    dims = mk.MlpDims.from_cfg(cfg)
    params = init_nerf_params(torch.Generator().manual_seed(cs.SEED), cfg, dev)
    fw, fb = (t.detach().contiguous() for t in mk.pack_params(params, dims))
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    pts = torch.rand(n, 3, generator=gen) * 8.0 - 4.0
    vd = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    g = (torch.randn(n, 4, generator=gen) * 1e-3).to(dev)
    xin = mk.pack_input(pts, vd).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, waves = mk.backward_blocks, WAVES
    ref = None
    for rnd in range(2):
        for name, lib in libs.items():
            _, per_sm, wv, rows = VARIANTS[name]
            build.load = lambda _name, lib=lib: lib
            mk.backward_blocks = (lambda d, m, per_sm=per_sm:
                                  max(1, min(m // mk.TILE, per_sm * sms)))
            mk.WGRAD_WAVES, mk.WGRAD_ROWS = wv, rows
            mk._tile_table.cache_clear()
            k4 = cs.cuda_ms(lambda: mk.mlp_forward(xin, fw, fb, dims), reps=10,
                            warmup=2)
            k5 = mk.K5Launch.prepare(xin, fw, fb, g, dims, False)
            k5.pass_()
            k5.wgrad()
            torch.cuda.synchronize()
            if ref is None:
                ref = k5.dw.clone()
            diff = float((k5.dw - ref).abs().max())
            k5a = cs.cuda_ms(k5.pass_, reps=10, warmup=1)
            k5b = cs.cuda_ms(k5.wgrad, reps=10, warmup=1)
            del k5
            torch.cuda.empty_cache()
            print(f"round {rnd} [{name}] K4 {k4:.4f} ms, K5a {k5a:.4f} ms, "
                  f"K5b {k5b:.4f} ms; max |dW − as built| {diff:.3e}",
                  flush=True)
            mk.backward_blocks, mk.WGRAD_WAVES = blocks, waves
            mk.WGRAD_ROWS = ROWS
            mk._tile_table.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
