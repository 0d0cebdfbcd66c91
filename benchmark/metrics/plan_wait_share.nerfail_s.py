"""Percentage of the traced epoch's step device time (`attack.step`) in
getting each batch's tables and plan from the plan cache (`attack.plan`:
the streamed copies from pinned host memory, and any idle before them)."""

from benchmark import spans


def read(run):
    return spans.device_share(spans.record(run), ("attack.plan",),
                              "attack.step")
