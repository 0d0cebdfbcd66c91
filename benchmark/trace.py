"""The traced run's reduction: `torch.profiler` over CPU and CUDA around
one stretch of the window, reduced to device busy time, time by kernel
name, and the idle gaps labelled by what the host was doing.

The stretch is marked by a `bench.window` span in the profiler's own
clock, so the device intervals and the window are on one time base.
Kernel time is the union of kernel intervals; copies and memsets count
toward `busy_s` (an operation ran on the device) but not toward kernel
time, so streamed copies read as idle in `idle_share`.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

WINDOW = "bench.window"
Interval = Tuple[int, int]


def _union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _length(intervals: List[Interval]) -> int:
    return sum(e - s for s, e in intervals)


@dataclass
class Summary:
    window_s: float
    busy_s: float                       # union of every device operation
    kernel_s: float                     # union of kernel intervals
    by_name: Dict[str, float]           # summed device seconds by name
    launches: Dict[str, int]            # device operations by name
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def seconds_of(self, *parts: str) -> float:
        """Summed device seconds of operations whose name holds any part."""
        return sum(v for k, v in self.by_name.items()
                   if any(p in k for p in parts))

    def breakdown(self) -> dict:
        ops = heapq.nlargest(10, self.by_name.items(), key=lambda kv: kv[1])
        gaps = heapq.nlargest(10, self.idle_by_host.items(),
                              key=lambda kv: kv[1])
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def _is_annotation(ev, host_spans) -> bool:
    """A host span that the profiler also draws on the device's timeline
    (`record_function`, the optimizer's step): no device work."""
    if ev.is_user_annotation() or ev.name() in host_spans:
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip()


def reduce_events(events) -> Summary:
    """Summary of kineto events (`prof.profiler.kineto_results.events()`)
    inside the `bench.window` span."""
    window: Optional[Interval] = None
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    host_spans = {WINDOW} | {ev.name() for ev in events
                             if ev.device_type() != cuda
                             and ev.is_user_annotation()}
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if ev.device_type() == cuda:
            if not _is_annotation(ev, host_spans):
                device.append((start, start + dur, short_name(name)))
        elif name == WINDOW:
            window = (start, start + dur)
        elif dur > 0:
            host.append((start, start + dur, name, ev.start_thread_id()))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = window
    by_name: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    every, kernels = [], []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        by_name[name] += (e - s) / 1e9
        launches[name] += 1
        every.append((s, e))
        if not _is_copy(name):
            kernels.append((s, e))
    busy = _union(kernels)
    summary = Summary(window_s=(w1 - w0) / 1e9,
                      busy_s=_length(_union(every)) / 1e9,
                      kernel_s=_length(busy) / 1e9,
                      by_name=dict(by_name), launches=dict(launches))
    summary.idle_by_host = _label_gaps(_gaps(busy, w0, w1), host)
    return summary


def _gaps(busy: List[Interval], w0: int, w1: int) -> List[Interval]:
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def _label_gaps(gaps: List[Interval], host) -> Dict[str, float]:
    """Idle seconds by the innermost host operation open at each gap's
    middle (host spans nest within a thread; across threads the latest
    started wins). A gap with no host span open is `host:untraced`."""
    points = sorted(((s + e) // 2, e - s) for s, e in gaps)
    host = sorted(host)
    stacks: Dict[int, list] = defaultdict(list)
    out: Dict[str, float] = defaultdict(float)
    j = 0
    for t, length in points:
        while j < len(host) and host[j][0] <= t:
            s, e, name, tid = host[j]
            stack = stacks[tid]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            j += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1][1] <= t:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        out[best[2] if best else "host:untraced"] += length / 1e9
    return dict(out)


class Tracer:
    """Profiles the stretch between `start()` and `stop()`; `summary` is
    the reduction once stopped. Does nothing on the CPU."""

    def __init__(self):
        self.prof = None
        self.span = None
        self.summary: Optional[Summary] = None

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = record_function(WINDOW)
        self.span.__enter__()

    def stop(self) -> Summary:
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.summary = reduce_events(self.prof.profiler.kineto_results.events())
        self.prof = self.span = None
        return self.summary
