"""Percentage of the traced render window in which no kernel ran."""

from benchmark.metrics.common import idle_share


def read(run):
    return idle_share(run)
