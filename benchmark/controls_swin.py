"""The readings that the Swin-B cell's limits are set from, on the card at
the cell's own size: the program's on several seeds, and two controls' on
a few, each checked against the float32 reference: the program's attack
run one precision below the configuration's float32 (TF32 matrix
products and convolutions), and the same with TF32 in the classifier's
backward alone (its forward, and so its logits, in float32).

    python3 benchmark/controls_swin.py --seeds 4 --control-seeds 2 \
        [--backward-seeds 2] [--offset 0] [--out <file.json>]

Prints one line per reading and, with --out, writes them all as JSON.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.controls import BASE_SEED, tf32  # noqa: E402
from benchmark.drivers import nerfail_s_swin  # noqa: E402

CELL = "swin_b_299.nerfail_s_400v"


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def tf32_backward(make):
    """`make_classifier_logits_fn` whose classifier runs its backward in
    TF32: on from the gradient at its logits to the gradient at its input
    (the backward's first and last tensors; the flags are global, so they
    hold in autograd's thread)."""
    def make_fn(model):
        fn = make(model)

        def logits_fn(x):
            out = fn(x)
            if x.requires_grad:
                out.register_hook(lambda g: set_tf32(True))
                x.register_hook(lambda g: set_tf32(False))
            return out

        return logits_fn

    return make_fn


@contextlib.contextmanager
def classifier_backward_in_tf32():
    make = nerfail_s_swin.make_classifier_logits_fn
    nerfail_s_swin.make_classifier_logits_fn = tf32_backward(make)
    try:
        yield
    finally:
        nerfail_s_swin.make_classifier_logits_fn = make
        set_tf32(False)


def readings(ctx, control) -> dict:
    """One short run (one window epoch) and its check; with `control`
    "tf32" (or True) the program's attack runs in TF32, with "backward"
    its classifier's backward alone."""
    if control == "backward":
        ctl = classifier_backward_in_tf32()
    elif control:
        ctl = tf32()
    else:
        ctl = contextlib.nullcontext()
    with ctl:
        nerfail_s_swin.measure(ctx)
    return {c.name: c.value for c in nerfail_s_swin.check(ctx)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--control-seeds", type=int, default=2)
    ap.add_argument("--backward-seeds", type=int, default=0)
    ap.add_argument("--offset", type=int, default=0,
                    help="first seed index, so that calls use fresh seeds")
    ap.add_argument("--out")
    args = ap.parse_args()
    set_tf32(False)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else (
        torch.device("cpu"))
    cell = harness.load_cell(CELL)
    plan = [("program", BASE_SEED + args.offset + s)
            for s in range(args.seeds)]
    plan += [("control", BASE_SEED + 1000 + args.offset + s)
             for s in range(args.control_seeds)]
    plan += [("backward", BASE_SEED + 2000 + args.offset + s)
             for s in range(args.backward_seeds)]
    out = []
    for kind, seed in plan:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, 0.0, dev)
        vals = readings(ctx, {"program": None, "control": "tf32",
                              "backward": "backward"}[kind])
        rec = {"cell": CELL, "kind": kind, "seed": seed, **vals,
               "views_per_s": ctx.e2e.get("nerfail_s_views_per_s"),
               "s": time.perf_counter() - t0}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
