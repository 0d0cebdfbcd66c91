"""Percentage of the traced views' kernel time spent in kernels other
than K4: the renderer's sampling, compositing and encoding glue."""

from benchmark.metrics.common import K4


def read(run):
    s = run.summary
    if s is None or s.kernel_s <= 0:
        return None
    k4 = s.seconds_of(*K4)
    return 100.0 * max(s.kernel_s - k4, 0.0) / s.kernel_s
