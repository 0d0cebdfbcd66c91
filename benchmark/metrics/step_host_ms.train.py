"""Median host milliseconds of the traced window's train steps: the
program's `train.step` spans, one an iteration of `train_nerf`'s loop."""

from benchmark import spans


def read(run):
    return spans.median_host_ms(spans.record(run), "train.step")
