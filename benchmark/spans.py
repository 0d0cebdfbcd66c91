"""The program's own spans and counters (`nerfail_tpu_torch.utils.
profiling`), read for the per-layer metrics of a traced run.

The program records only while a profiler session records, and the
traced run's session covers the window alone, so the record is the
window's: spans with their parent, `host_ms` and `device_ms` (CUDA
events on the program's stream), and counters. A device share counts the
device's idle inside a span as that span's time. Where there is nothing
to read (an untraced run, the CPU, a program without the record) each
function returns None.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional


def record(run) -> Optional[dict]:
    """The program's record of the traced window, or None."""
    if run.summary is None:
        return None
    from nerfail_tpu_torch.utils import profiling

    read = getattr(profiling, "trace_record", None)
    if read is None:
        return None
    rec = read()
    return rec if rec["spans"] or rec["counters"] else None


def named(rec: Optional[dict], name: str) -> List[dict]:
    return [s for s in rec["spans"] if s["name"] == name] if rec else []


def _inside(rec: dict, span: dict, outer: str) -> bool:
    p = span["parent"]
    while p is not None:
        if rec["spans"][p]["name"] == outer:
            return True
        p = rec["spans"][p]["parent"]
    return False


def median_host_ms(rec: Optional[dict], name: str) -> Optional[float]:
    """Median host milliseconds of the spans `name`."""
    ms = [s["host_ms"] for s in named(rec, name)]
    return statistics.median(ms) if ms else None


def device_share(rec: Optional[dict], parts: Iterable[str],
                 whole: str) -> Optional[float]:
    """Percentage of the summed `device_ms` of the spans `whole` that the
    spans named in `parts` inside them take."""
    outer = named(rec, whole)
    if not outer or any(s["device_ms"] is None for s in outer):
        return None
    total = sum(s["device_ms"] for s in outer)
    inner = [s for name in parts for s in named(rec, name)
             if _inside(rec, s, whole)]
    if total <= 0 or any(s["device_ms"] is None for s in inner):
        return None
    return 100.0 * sum(s["device_ms"] for s in inner) / total


def per_span(rec: Optional[dict], counter: str,
             name: str) -> Optional[float]:
    """The counter over the number of spans `name` (0 where the program
    never counted it)."""
    n = len(named(rec, name))
    if not n:
        return None
    return rec["counters"].get(counter, 0) / n
