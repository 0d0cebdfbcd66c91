"""Arithmetic that the per-layer readers share. Every share is in percent
of a bound computed from `counts/` against the card's published peaks;
a reader with nothing to read returns None, never 0."""

from __future__ import annotations

from typing import Optional

from benchmark.counts import nerf as counts
from benchmark.counts.peaks import bound_seconds

K4 = ("mlp_fwd_ws_kernel",)
# K5: K5a (recompute and backward), K5b (dW GEMM) and their split sums
K5 = ("mlp_bwd_pass_kernel", "mlp_wgrad_kernel", "reduce_parts_kernel")


def idle_share(run) -> Optional[float]:
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.kernel_s / s.window_s)


def mfu(run, flops: float) -> Optional[float]:
    s = run.summary
    if s is None or flops <= 0 or s.window_s <= 0:
        return None
    return 100.0 * flops / s.window_s / run.peaks.bf16


def roofline(run, names, flops: float, nbytes: float) -> Optional[float]:
    s = run.summary
    if s is None:
        return None
    t = s.seconds_of(*names)
    if t <= 0:
        return None
    return 100.0 * bound_seconds(flops, nbytes, run.peaks.bf16,
                                 run.peaks) / t


def train_points(run):
    """(coarse, fine) points of the traced train steps."""
    c, f = counts.points_per_step(run.cfg["render"],
                                  run.cfg["train"]["N_rand"])
    n = run.stats.get("steps", 0)
    return c * n, f * n


def render_points(run):
    c, f = counts.points_per_step(run.cfg["render"], run.stats.get("n_rays", 0))
    n = run.stats.get("views", 0)
    return c * n, f * n


def work(fn, model, points):
    """Summed (flops, bytes) of one kernel over passes of `points`."""
    parts = [fn(model, p) for p in points if p > 0]
    return sum(a for a, _ in parts), sum(b for _, b in parts)
