"""Percentage of Swin-B's forward device time (`attack.classify`) in its
blocks' attention halves (`swin.attention`: LayerNorm, pad, roll,
partition, attention, reverse, roll back, crop); None where the program
records no such span."""

from benchmark import spans


def read(run):
    rec = spans.record(run)
    if not spans.named(rec, "swin.attention"):
        return None
    return spans.device_share(rec, ("swin.attention",), "attack.classify")
