"""Timing, memory, tracing and roofline accounting on the card.

Ports nerfail_tpu/utils/profiling.py:

  * `nerf_mlp_flops_per_point`, `nerf_train_step_flops` — the analytic
    FLOP counts, as the JAX package has them
  * `fence`          — waits for the card (`torch.cuda.synchronize`)
  * `timed`          — seconds per call: CUDA events on the card,
    `perf_counter` on the CPU
  * `device_memory_gb` — the caching allocator's byte counters in GiB
  * `device_trace`   — `torch.profiler` over CPU and CUDA, exported as a
    Chrome trace
  * `roofline`       — a measured call placed against the card's peaks
  * `span`, `count`, `span_to_grad`, `trace_record` — the program's own
    spans and counters, kept while a `torch.profiler` session records

PyTorch has no counterpart of XLA's cost analysis, so `roofline` takes the
work (flops, bytes) from the caller. The peaks are looked up by
`torch.cuda.get_device_name`; `PEAKS` holds the one card the port is
measured on, with the figures of NVIDIA's H100 SXM data sheet.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function


@dataclass(frozen=True)
class Peaks:
    """A card's published peaks: device-memory bytes/s, fp32 flop/s
    outside the tensor cores (an FMA counts two) and dense bf16
    tensor-core flop/s."""

    bytes_per_s: float
    fp32: float
    bf16: float


# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit:
# HBM3 3.35 TB/s, fp32 67 TFLOP/s, bf16 989 TFLOP/s
H100_SXM = Peaks(bytes_per_s=3.35e12, fp32=67e12, bf16=989e12)

PEAKS: Dict[str, Peaks] = {"NVIDIA H100 80GB HBM3": H100_SXM}


def nerf_mlp_flops_per_point(mcfg) -> int:
    """Analytic matmul FLOPs for one forward through the NeRF MLP."""
    dims = []
    fan_in = mcfg.input_ch
    W = mcfg.netwidth
    for i in range(mcfg.netdepth):
        dims.append((fan_in, W))
        fan_in = W + mcfg.input_ch if i in mcfg.skips else W
    if mcfg.use_viewdirs:
        dims += [
            (W, W), (W, 1),
            (W + mcfg.input_ch_views, W // 2), (W // 2, 3),
        ]
    else:
        dims += [(W, 4)]
    return 2 * sum(a * b for a, b in dims)


def nerf_train_step_flops(mcfg, rcfg, n_rand: int) -> float:
    """Analytic FLOPs of one train step: coarse (N_samples pts/ray) + fine
    (N_samples+N_importance pts/ray) forwards, backward ≈ 2× forward."""
    per_pt = nerf_mlp_flops_per_point(mcfg)
    pts = n_rand * (2 * rcfg.N_samples + rcfg.N_importance)
    return 3.0 * per_pt * pts


def _cuda_device(x) -> Optional[torch.device]:
    if torch.is_tensor(x):
        return x.device if x.is_cuda else None
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            d = _cuda_device(v)
            if d is not None:
                return d
    return None


def fence(tree) -> None:
    """Wait until the card has finished the work queued before this call
    on the device of the first CUDA tensor in `tree` (a tensor, or nested
    lists, tuples and dicts of them); nothing for CPU tensors, which are
    ready when returned."""
    dev = _cuda_device(tree)
    if dev is not None:
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> float:
    """Mean seconds per call of fn(*args). On the card, by CUDA events
    around `iters` calls after `warmup` (device time of the queued work);
    on the CPU, by perf_counter."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    dev = _cuda_device(out) or _cuda_device(args)
    if dev is None:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def device_memory_gb(device="cuda") -> Dict[str, float]:
    """The caching allocator's `*bytes*` counters of `device` in GiB, and
    `max_memory_allocated` as `peak_allocated_gb`."""
    stats = torch.cuda.memory_stats(device)
    out = {k: v / 2 ** 30 for k, v in stats.items()
           if "bytes" in k and isinstance(v, (int, float))}
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return out


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over CPU and, where there is a card, CUDA activity;
    on exit the Chrome trace goes to `logdir/trace.json`. Yields the
    profiler, whose `key_averages()` sums the kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    clear_record()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Spans and counters. They record only while a torch.profiler session
# records; otherwise `span` hands back one shared no-op context and
# `count` returns at once, after one check of about 0.1 µs.

_NOOP = contextlib.nullcontext()
_local = threading.local()


def _stack() -> List["_Span"]:
    """This thread's open spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event() -> Optional[torch.cuda.Event]:
    """A timing event recorded on the current stream, where the program
    has started CUDA and the stream is not being captured."""
    if not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "parent", "t0", "t1", "ev0", "ev1", "_rf")

    def __init__(self, name: str, parent: Optional["_Span"]):
        self.name, self.parent = name, parent
        self.t0 = self.t1 = self.ev0 = self.ev1 = self._rf = None

    def __enter__(self) -> "_Span":
        self._rf = record_function("nerfail." + self.name)
        self._rf.__enter__()
        _stack().append(self)
        _RECORD.spans.append(self)
        self.ev0 = _event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.ev1 = _event()
        self.t1 = time.perf_counter_ns()
        _stack().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        return False


class _Record:
    def __init__(self):
        self.spans: List[_Span] = []
        self.counters: Dict[str, int] = defaultdict(int)


_RECORD = _Record()


def span(name: str):
    """A context that records `name` while a profiler session records:
    `record_function("nerfail." + name)` in the profiler's trace, and in
    the record its parent (the span open on this thread), host start and
    end, and, on a card, CUDA events on the current stream at both ends.
    Whether it records is decided here: a span entered with no session
    records nothing, one entered during a session closes its record
    though the session stopped inside it."""
    if not _profiler_enabled():
        return _NOOP
    stack = _stack()
    return _Span(name, stack[-1] if stack else None)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the record's counter `name` while a session records."""
    if _profiler_enabled():
        _RECORD.counters[name] += n


def span_to_grad(x: torch.Tensor, name: str) -> None:
    """While a session records, hook `x` so that when its gradient is
    computed, `name` is recorded as a child of the span then open on this
    thread, from that span's start to that point (one CUDA event on the
    backward's current stream). The hook returns nothing: the gradient is
    untouched."""
    if not _profiler_enabled() or not x.requires_grad:
        return
    stack = _stack()

    def hook(grad):
        if not stack:
            return
        parent = stack[-1]
        s = _Span(name, parent)
        s.t0, s.ev0 = parent.t0, parent.ev0
        s.ev1 = _event()
        s.t1 = time.perf_counter_ns()
        _RECORD.spans.append(s)

    x.register_hook(hook)


def clear_record() -> None:
    """Forget every span and counter recorded so far."""
    _RECORD.spans, _RECORD.counters = [], defaultdict(int)


def trace_record() -> dict:
    """The closed spans and the counters recorded since the record was
    last cleared: {"spans": [{"name", "parent" (index or None),
    "host_ms", "device_ms", "self_host_ms", "self_device_ms"}],
    "counters": {name: n}}. `device_ms` runs from the point where the
    work queued before the span finished to the point where the span's
    own work finished (None without a card); it waits for the card. A
    self time is the span's less its children's."""
    spans = [s for s in _RECORD.spans if s.t1 is not None]
    if any(s.ev1 is not None for s in spans):
        torch.cuda.synchronize()
    index = {id(s): i for i, s in enumerate(spans)}
    out = []
    for s in spans:
        dev = (s.ev0.elapsed_time(s.ev1)
               if s.ev0 is not None and s.ev1 is not None else None)
        host = (s.t1 - s.t0) / 1e6
        out.append({"name": s.name, "parent": index.get(id(s.parent)),
                    "host_ms": host, "device_ms": dev,
                    "self_host_ms": host, "self_device_ms": dev})
    for r in out:
        p = r["parent"]
        if p is None:
            continue
        out[p]["self_host_ms"] -= r["host_ms"]
        if out[p]["self_device_ms"] is not None and r["device_ms"] is not None:
            out[p]["self_device_ms"] -= r["device_ms"]
    return {"spans": out, "counters": dict(_RECORD.counters)}


def card_peaks(device="cuda") -> Peaks:
    """The peaks of the card at `device`; raises for a card `PEAKS` does
    not list."""
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}; pass peaks=")
    return PEAKS[name]


@dataclass
class Roofline:
    seconds: float
    flops: float
    bytes_accessed: float
    tflops_per_s: float
    gbytes_per_s: float
    flops_utilization: float
    hbm_utilization: float
    bound_seconds: float
    bound: str

    def __str__(self) -> str:
        return (
            f"{self.seconds * 1e3:.4f} ms | {self.tflops_per_s:.2f} TFLOP/s "
            f"({self.flops_utilization:.2%} of peak) | "
            f"{self.gbytes_per_s:.1f} GB/s ({self.hbm_utilization:.2%}) | "
            f"bound {self.bound_seconds * 1e3:.4f} ms by {self.bound}"
        )


def roofline_of(seconds: float, flops: float, bytes_accessed: float,
                peak_flops: float, peak_bytes: float) -> Roofline:
    """Place a call that took `seconds` for `flops` operations and
    `bytes_accessed` bytes against the peaks. The bound is the larger of
    flops / peak_flops and bytes / peak_bytes."""
    t_ops, t_bytes = flops / peak_flops, bytes_accessed / peak_bytes
    return Roofline(
        seconds=seconds, flops=flops, bytes_accessed=bytes_accessed,
        tflops_per_s=flops / seconds / 1e12,
        gbytes_per_s=bytes_accessed / seconds / 1e9,
        flops_utilization=t_ops / seconds,
        hbm_utilization=t_bytes / seconds,
        bound_seconds=max(t_ops, t_bytes),
        bound="operations" if t_ops >= t_bytes else "bytes",
    )


def roofline(fn: Callable, *args, flops: float, bytes_accessed: float,
             dtype: str = "bf16", peaks: Optional[Peaks] = None,
             iters: int = 20, warmup: int = 2) -> Roofline:
    """Time fn(*args) (`timed`) and place it on the roofline of the card
    it ran on: `flops` operations in `dtype` ("bf16" on the tensor cores
    or "fp32") and `bytes_accessed` bytes, as the caller counts them.
    `peaks` defaults to the card's entry in `PEAKS`, and an unlisted card
    raises."""
    if peaks is None:
        dev = _cuda_device(args)
        if dev is None:
            raise ValueError("roofline needs CUDA arguments or peaks=")
        peaks = card_peaks(dev)
    secs = timed(fn, *args, iters=iters, warmup=warmup)
    return roofline_of(secs, flops, bytes_accessed, getattr(peaks, dtype),
                       peaks.bytes_per_s)
