"""Byte-budgeted device cache for static per-batch attack tables.

The attack engines reuse the same neighbor tables and splat plans every
epoch (they are static per batch). Keeping them all on the card runs out
of memory at reference scale (300 views × 800²), while rebuilding them
every step repeats the plan build. This cache takes the middle road:

  * entries stay on the device while the running total stays under
    `budget_bytes` (first-come, in batch order — batches repeat in the
    same order every epoch, so FIFO pinning is the best static placement
    for a sequential schedule);
  * past the device budget, an entry keeps a HOST copy under
    `host_budget_bytes` (page-locked when the device is a card, so the
    copy back is asynchronous), so the build runs once per batch per run;
  * entries past both budgets rebuild on every get.

A host copy can be sent back ahead of its get: `prefetch(key)` starts its
copy on a stream the cache owns, so it crosses PCIe under the card's
current work, and the get that takes it makes the current stream wait
for it on the card. The host waits once a prefetch, on an event, so that
it runs no more than one batch ahead of the card.

While a profiler session records, every get of a host copy adds to the
counters of `utils.profiling`'s record: `plan_cache.streamed_gets` and
`plan_cache.streamed_bytes` (the copies sent back to the card), and
`plan_cache.prefetched_gets` where a prefetch had sent it.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Tuple, Union

import torch

from nerfail_tpu_torch.ops.cuda.segsum_kernel import CsrPlan
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device
from nerfail_tpu_torch.utils.profiling import count

Item = Union[torch.Tensor, CsrPlan]


def _nbytes(items) -> int:
    return sum(x.nbytes if isinstance(x, CsrPlan)
               else x.numel() * x.element_size() for x in items)


def _tensors(items):
    for x in items:
        yield from x.tensors() if isinstance(x, CsrPlan) else (x,)


def _host_copy(x: Item, pin: bool) -> Item:
    if isinstance(x, CsrPlan):
        return x.map(lambda t: _host_copy(t, pin))
    x = x.to("cpu")
    return x.pin_memory() if pin else x


class DeviceBudgetCache:
    """key → tuple of tensors / CsrPlans on the device, kept there while
    under a byte budget."""

    def __init__(self, budget_bytes: int = 2 << 30,
                 host_budget_bytes: int = 64 << 30,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.budget_bytes = int(budget_bytes)
        self.host_budget_bytes = int(host_budget_bytes)
        self._pinned: Dict[Hashable, Tuple] = {}
        # key -> (host copies, their bytes)
        self._host: Dict[Hashable, Tuple[Tuple, int]] = {}
        self._used = 0
        self._host_used = 0
        # key -> (its copies on the card, and the event the copy stream
        # recorded after them)
        self._ahead: Dict[Hashable, Tuple[Tuple, torch.cuda.Event]] = {}
        self._copy_stream: Optional[torch.cuda.Stream] = None
        # the current stream's point at the last prefetch
        self._fence: Optional[torch.cuda.Event] = None

    def get(self, key: Hashable, build: Callable[[], Tuple]) -> Tuple:
        """build() returns a tuple of tensors / CsrPlans on this cache's
        device; so does get()."""
        if key in self._pinned:
            return self._pinned[key]
        if key in self._host:
            items, size = self._host[key]
            count("plan_cache.streamed_gets")
            count("plan_cache.streamed_bytes", size)
            if key not in self._ahead:
                return tuple(x.to(self.device, non_blocking=True)
                             for x in items)
            dev, copied = self._ahead.pop(key)
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            # the copy stream allocated them: the allocator must not hand
            # their memory back to it before this stream is done with them
            for t in _tensors(dev):
                t.record_stream(stream)
            count("plan_cache.prefetched_gets")
            return dev
        dev = tuple(build())
        size = _nbytes(dev)
        if self._used + size <= self.budget_bytes:
            self._pinned[key] = dev
            self._used += size
        elif self._host_used + size <= self.host_budget_bytes:
            # the first transfer rode the build: not a streamed get
            pin = self.device.type == "cuda"
            self._host[key] = (tuple(_host_copy(x, pin) for x in dev), size)
            self._host_used += size
        return dev

    def prefetch(self, key: Hashable) -> None:
        """Start sending `key`'s host copy to the card on the cache's copy
        stream, for the get that takes it. Nothing to do for a key held on
        the card, one not built yet, one already on its way, or a cache on
        the CPU.

        Each prefetch first waits on the host for the current stream to
        reach the point of the previous prefetch. With one get per
        prefetch, as a loop over batches makes them, the host then runs at
        most one batch ahead of the card, and no more than two streamed
        batches are on the card beyond the one it is finishing: the one
        handed out and the one on its way."""
        if self.device.type != "cuda":
            return
        if self._copy_stream is None:
            # made at the first call, which a loop over batches makes while
            # it builds them, not under the first copy
            self._copy_stream = torch.cuda.Stream(self.device)
        if key not in self._host or key in self._ahead:
            return
        if self._fence is not None:
            self._fence.synchronize()
        self._fence = torch.cuda.current_stream(self.device).record_event()
        with torch.cuda.stream(self._copy_stream):
            dev = tuple(x.to(self.device, non_blocking=True)
                        for x in self._host[key][0])
            self._ahead[key] = (dev, self._copy_stream.record_event())

    def drop_prefetched(self) -> None:
        """Forget the prefetches no get has taken, and free their memory."""
        self._ahead.clear()
