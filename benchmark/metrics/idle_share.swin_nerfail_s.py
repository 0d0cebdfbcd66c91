"""Percentage of the traced NeRFail-S epoch with Swin-B in which no
kernel ran; the plan cache's streamed host-to-device copies count as
idle."""

from benchmark.metrics.common import idle_share


def read(run):
    return idle_share(run)
