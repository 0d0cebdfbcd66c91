"""Gigabytes the plan cache sent from pinned host memory to the card
(`plan_cache.streamed_bytes`) per traced epoch (`attack.epoch_end`)."""

from benchmark import spans


def read(run):
    gb = spans.per_span(spans.record(run), "plan_cache.streamed_bytes",
                        "attack.epoch_end")
    return None if gb is None else gb / 1e9
