"""K4's bound (`counts.nerf.k4_work`) over K4's device time in the traced
train steps, in percent."""

from benchmark.counts import nerf as counts
from benchmark.metrics.common import K4, roofline, train_points, work


def read(run):
    flops, nbytes = work(counts.k4_work, run.cfg["model"], train_points(run))
    return roofline(run, K4, flops, nbytes)
