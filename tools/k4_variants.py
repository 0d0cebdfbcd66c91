#!/usr/bin/env python3
"""Variants of K4 (csrc/nerf_mlp.cu `mlp_fwd_ws_kernel`) on one card.

    python3 tools/k4_variants.py [other.cu ...]

Run from the repository root. Each variant is the source with a few lines
replaced, built with the same nvcc flags into `_proof/k4_variants/` (listed
in .gitignore). Each is timed with CUDA events on the kernel's launch alone
(the weights packed once, outside the timed region), twice in turns, at a
full-width train step's 262 144 points (8×256, `chip_smoke.k45_phase`'s
inputs), at the 64² quality run's 16 384 and 32 768 points (4×128), and
at a coarse pass's 65 536 points at depth 8 and every other width class
(32 … 224).
Each `other.cu` named on the command line (a whole other version of
csrc/nerf_mlp.cu with the same C interface and weight stream) is timed
beside them. The variants that skip work (`no weight copies`, `no
encoding`) give wrong outputs and measure what that work costs; the
others, and the other sources, must give the same bits as the source as
built.
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

OUT = "_proof/k4_variants"

COPY = ("            mbar_expect_tx(full + 8 * stage, bytes);\n"
        "            bulk_load(slots + stage * p.slot, src, bytes, full + 8 * stage);\n")
ENCODE = "  for (int u = h; u < 3 * L; u += 2) {\n"
UNROLL = "#pragma unroll 8\n" + ENCODE
STAGES = "constexpr int K4_MAX_STAGES = 8;"
# the consumers in an enforced ping-pong order (FlashAttention-3's): each
# waits on a named barrier for its turn before a turn's first slice and
# arrives on the other's after the turn's last; the slices between two
# epilogues (a run) are cut into turns of at most stages - 1 slices, as
# even as can be, the longer first (tests/test_torch_k4_stream.py walks
# this protocol on the CPU)
TURNS = """// named barriers 3 and 4: consumer 0's turn, consumer 1's
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(3 + (wg ^ 1)) : "memory");
}

// bit k of m: the run's k-th next slice starts a turn (bit len: its end)
struct Turns {
  unsigned m;

  __device__ __forceinline__ void run(int len, int limit) {
    const int turns = (len + limit - 1) / limit;
    m = 1u << len;
    for (int t = 0, at = 0; t < turns; ++t) {
      m |= 1u << at;
      at += len / turns + (t < len % turns ? 1 : 0);
    }
  }

  __device__ __forceinline__ void begin(int wg) {
    if (m & 1) turn_wait(wg);
  }

  __device__ __forceinline__ void end(int wg) {
    m >>= 1;
    if (m & 1) turn_pass(wg);
  }
};

"""
GEMM_DOC = "// acc (+)= [A_0 | A_1] · B: A_o is the [64, k_o] tile at shared address\n"
CALLS = ["gemm(acc, rg, ax, d.in_pad, 0u, 0, false);",
         "gemm(acc, rg, ax, d.in_pad, ah, W, false);",
         "gemm(acc, rg, ah, W, 0u, 0, false);",
         "gemm(acch, rg, ah, W, 0u, 0, false);",
         "gemm(accv, rg, ah, W, ad, d.vd_pad, false);",
         "gemm(acch, rg, ah, W / 2, 0u, 0, true);"]
PING_PONG = [
    (GEMM_DOC, TURNS + GEMM_DOC),
    ("void gemm(Acc<N>& acc, Ring& rg, unsigned a0,",
     "void gemm(Acc<N>& acc, Ring& rg, Turns& tn, int wg, unsigned a0,"),
    ("      mbar_wait(rg.full + 8 * rg.stage, rg.phase);\n      const",
     "      tn.begin(wg);\n      mbar_wait(rg.full + 8 * rg.stage, rg.phase);\n"
     "      const"),
    ("      wgmma_commit();\n      wgmma_wait<1>();",
     "      wgmma_commit();\n      tn.end(wg);\n      wgmma_wait<1>();"),
    ("    Ring rg{slots, full, empty, p.stages, p.slot, 0, -1, 0u};\n",
     "    Ring rg{slots, full, empty, p.stages, p.slot, 0, -1, 0u};\n"
     "    Turns tn{0u};\n    const int limit = p.stages - 1;\n"),
    ("    zero_acc(acch);\n\n    for (int tile",
     "    zero_acc(acch);\n    if (wg == 1) turn_pass(wg);   // 0 goes first\n\n"
     "    for (int tile"),
    ("      for (int i = 0; i < D; ++i) {\n",
     "      for (int i = 0; i < D; ++i) {\n        tn.run(p.mat_slices[i], limit);\n"),
    ("      gemm(acch, rg, ah, W, 0u, 0, false);\n",
     "      tn.run(p.mat_slices[D] + p.mat_slices[D + 1], limit);\n"
     "      gemm(acch, rg, ah, W, 0u, 0, false);\n"),
    ("      gemm(accv, rg,", "      tn.run(p.mat_slices[D + 2], limit);\n      gemm(accv, rg,"),
    ("      gemm(acch, rg, ah, W / 2,",
     "      tn.run(p.mat_slices[D + 3], limit);\n      gemm(acch, rg, ah, W / 2,"),
    ("      zero_acc(acch);\n    }\n  }\n}",
     "      zero_acc(acch);\n    }\n    if (wg == 0) turn_wait(wg);   // 1's last pass\n"
     "  }\n}"),
] + [(c, c.replace("rg, ", "rg, tn, wg, ", 1)) for c in CALLS]

# name: source replacements (old, new); `exact` variants must match the
# source as built bit for bit
VARIANTS = {
    "as built": [],
    "3 stages": [(STAGES, "constexpr int K4_MAX_STAGES = 3;")],
    "2 stages": [(STAGES, "constexpr int K4_MAX_STAGES = 2;")],
    "no weight copies": [(COPY, "            mbar_arrive(full + 8 * stage);\n")],
    "encoding unrolled 4": [(UNROLL, "#pragma unroll 4\n" + ENCODE)],
    "no encoding": [(ENCODE, "  for (int u = h; u < 0; u += 2) {\n")],
    "ping-pong order": PING_PONG,
}
EXACT = {"as built", "2 stages", "3 stages", "encoding unrolled 4",
         "ping-pong order"}


def sources(src: str, others=()):
    """{name: the variant's source}; raises before anything is built if a
    replaced line is missing."""
    out = {}
    for name, subs in VARIANTS.items():
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name!r}: source line not found")
            s = s.replace(old, new)
        out[name] = s
    for path in others:
        with open(path) as f:
            out[os.path.basename(path)] = f.read()
    return out


def build_variants(src: str, others=()):
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for i, (name, s) in enumerate(sources(src, others).items()):
        cu, so = f"{OUT}/v{i}.cu", os.path.abspath(f"{OUT}/libv{i}.so")
        with open(cu, "w") as f:
            f.write(s)
        jobs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0 and name not in VARIANTS:
            print(f"[{name}] failed to build, left out:\n"
                  + "\n".join(log.splitlines()[-40:]), flush=True)
            continue
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        print(f"[{name}] ptxas (registers, spill stores, spill loads): "
              f"{cs.ptxas_counts(log, 'mlp_fwd_ws_kernel')}", flush=True)
        for line in log.splitlines():
            # and ptxas's notes on wgmma serialised in K4 (C7519, C7520)
            if "warning" in line or ("(C75" in line
                                     and "mlp_fwd_ws_kernel" in line):
                print(f"[{name}] {line.strip()}", flush=True)
        lib = ctypes.CDLL(so)
        lib.nerf_mlp_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p]
        libs[name] = lib
    return libs


def case(cfg, n, dev):
    dims = mk.MlpDims.from_cfg(cfg)
    params = init_nerf_params(torch.Generator().manual_seed(cs.SEED), cfg, dev)
    fw, fb = (t.detach().contiguous() for t in mk.pack_params(params, dims))
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    pts = torch.rand(n, 3, generator=gen) * 8.0 - 4.0
    vd = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    xin = mk.pack_input(pts, vd).to(dev)
    return dims, xin, mk.pack_stream(fw, dims), fb


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(build.CSRC, "nerf_mlp.cu")) as f:
        libs = build_variants(f.read(), sys.argv[1:])
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    cases = [("8x256", case(NeRFModelConfig(), cs.K45_POINTS, dev))] + [
        ("4x128", case(NeRFModelConfig(netdepth=4, netwidth=128), n, dev))
        for n in (512 * 32, 512 * 64)] + [
        (f"8x{w}", case(NeRFModelConfig(netwidth=w), 1024 * 64, dev))
        for w in range(32, 256, 32)]
    refs = {}
    for rnd in range(2):
        for name, lib in libs.items():
            parts = []
            for label, (dims, xin, wp, fb) in cases:
                n = xin.shape[0]
                out = torch.empty(n, 4, device=dev)
                stream = torch.cuda.current_stream().cuda_stream

                def launch():
                    build.check(lib.nerf_mlp_fwd_launch(
                        dims.array(), xin.data_ptr(), wp.data_ptr(),
                        fb.data_ptr(), out.data_ptr(), None, n, stream),
                        "nerf_mlp_fwd_launch")

                ms = cs.cuda_ms(launch, reps=20, warmup=3)
                launch()
                torch.cuda.synchronize()
                key = (label, n)
                if name == "as built":
                    refs.setdefault(key, out.clone())
                same = key in refs and torch.equal(out, refs[key])
                fl = 2 * n * dims.macs_per_point()
                parts.append(f"{label} {n}: {ms:.4f} ms "
                             f"({fl / ms / 1e9:.1f} TFLOP/s)"
                             + ("" if same or (name in VARIANTS
                                               and name not in EXACT)
                                else " DIFFERS"))
            print(f"round {rnd} [{name}] " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
