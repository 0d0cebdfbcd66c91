"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's files by name (BENCHMARK.json, workloads/<cell>.json,
configs/<config>.json, drivers/<engine>.py, metrics/<metric>.py), sets
up, measures for --seconds, checks what the timed path produced against
the plain reference, and prints one JSON line last on standard output:
the cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1. Each number compared is printed beside its limit as the last
lines of standard error and under "checks", the line's last key.
Exits non-zero, with no line, where there is no card or too few, or
where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device, t_start: float = T_START):
    """Set up, measure, check; returns (result line dict, check lines).
    The caller has made sure of the device."""
    import torch

    from benchmark.counts.peaks import peaks_of, power_limit_w
    from benchmark.trace import Tracer

    cell = harness.load_cell(args.workload)
    ctx = harness.Context(cell, args.seed, args.seconds, device)
    on_card = device.type == "cuda"
    if on_card:
        ctx.peaks = peaks_of(torch.cuda.get_device_name(device))
    drv = harness.driver(cell.workload["engine"])
    ctx.mark("imports")
    tracer = Tracer() if args.trace and on_card else None
    drv.measure(ctx, tracer)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = ctx.stats["setup_end"] - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx.summary = tracer.summary if tracer is not None else None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    bad = harness.forbidden_modules()
    if bad:
        raise SystemExit(f"loaded {', '.join(bad)}: the benchmark must not "
                         f"load JAX or the JAX package")
    t_check = time.perf_counter()
    checks = drv.check(ctx)
    t_check = time.perf_counter() - t_check
    if args.trace:
        metrics = harness.per_layer_values(ctx) if on_card else {}
    else:
        metrics = {m["name"]: {"value": ctx.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in ctx.e2e}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w() if on_card else None}
    line = {"correct": all(c.ok for c in checks), "attempted": ctx.attempted,
            "failed": ctx.failed, "metrics": metrics, "device": dev}
    if ctx.summary is not None:
        dev["busy_s"] = ctx.summary.busy_s
        dev["window_s"] = ctx.summary.window_s
        line["breakdown"] = ctx.summary.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    marks = [f"setup {label} at {t - t_start:.3f} s"
             for label, t in ctx.stats.get("marks", [])]
    marks += [f"info {k} {v!r} (not compared)"
              for k, v in ctx.stats.get("info", {}).items()]
    marks.append(f"info check_s {t_check:.3f} (the comparison's time)")
    return line, marks + harness.check_lines(checks)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, checks = run_cell(args, torch.device("cuda", 0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(checks) + "\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
