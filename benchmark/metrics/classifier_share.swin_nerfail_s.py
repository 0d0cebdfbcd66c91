"""Percentage of the traced epoch's step device time (`attack.step`) in
Swin-B: its two forwards (`attack.classify`) and its part of the
backward, up to the gradient of its input (`attack.classify_backward`)."""

from benchmark import spans


def read(run):
    return spans.device_share(
        spans.record(run), ("attack.classify", "attack.classify_backward"),
        "attack.step")
