"""What every cell shares: finding a cell's files by name, the run's
context, the checks that decide `correct`, and the last line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerfail_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict            # benchmark/workloads/<cell>.json
    config: dict              # benchmark/configs/<config>.json
    chips: int
    end_to_end: List[dict]    # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its workload and
    configuration files; raises KeyError for a cell it does not list."""
    bench = load_json(root, "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    workload = load_json(HERE, "workloads", f"{name}.json")
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names {workload['config']},"
                         f" BENCHMARK.json {entry['config']}")
    config = load_json(HERE, "configs", f"{entry['config']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, workload, config, entry["chips"], e2e, layer)


def driver(engine: str):
    return importlib.import_module(f"benchmark.drivers.{engine}")


def reader(metric: str):
    """metrics/<metric>.py (metric names hold dots, so by file path)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Check:
    """One number compared with the reference and its limit: the run is
    correct where value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    device: Any
    # filled by the engine's measure(): end-to-end values, counts, trace
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    stats: Dict[str, Any] = field(default_factory=dict)
    summary: Any = None       # trace.Summary of a traced run
    peaks: Any = None         # counts.peaks.Peaks of the card
    # what the engine's check() needs from its measure(), kept on the host
    keep: Dict[str, Any] = field(default_factory=dict)

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.workload["traffic"]

    def mark(self, label: str) -> None:
        """Note the time at which a part of set-up ended."""
        import time

        self.stats.setdefault("marks", []).append((label, time.perf_counter()))

    def limit(self, name: str) -> float:
        return float(self.cell.workload["limits"][name])


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (nerfail_tpu_torch is not nerfail_tpu)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def per_layer_values(ctx: Context) -> Dict[str, dict]:
    out = {}
    for m in ctx.cell.per_layer:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def check_lines(checks: List[Check]) -> List[str]:
    return [f"check {c.name} {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAIL'}" for c in checks]
