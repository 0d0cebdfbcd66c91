"""Percentage of the rows through Swin-B's qkv projections that are
window padding (`swin.pad_rows` over `swin.qkv_rows`, counted from the
shapes) in the traced epoch; None where the program counts neither."""

from benchmark import spans


def read(run):
    rec = spans.record(run)
    rows = rec["counters"].get("swin.qkv_rows", 0) if rec else 0
    if rows <= 0:
        return None
    return 100.0 * rec["counters"].get("swin.pad_rows", 0) / rows
