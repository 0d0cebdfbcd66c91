"""K5's bound (the backward's input and weight gradients in bf16, no
recompute: `counts.nerf.k5_work`) over K5's device time (K5a, K5b and
their split sums) in the traced train steps, in percent."""

from benchmark.counts import nerf as counts
from benchmark.metrics.common import K5, roofline, train_points, work


def read(run):
    flops, nbytes = work(counts.k5_work, run.cfg["model"], train_points(run))
    return roofline(run, K5, flops, nbytes)
