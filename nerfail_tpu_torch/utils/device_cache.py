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
  * entries past both budgets rebuild on every get (counted in
    `rebuilds`, so callers can warn).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple, Union

import torch

from nerfail_tpu_torch.ops.cuda.segsum_kernel import CsrPlan
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

Item = Union[torch.Tensor, CsrPlan]


def _nbytes(items) -> int:
    return sum(x.nbytes if isinstance(x, CsrPlan)
               else x.numel() * x.element_size() for x in items)


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
        self._host: Dict[Hashable, Tuple] = {}
        self._seen = set()
        self._used = 0
        self._host_used = 0
        self.streamed_gets = 0
        self.rebuilds = 0      # REDUNDANT builds (key seen before)

    def get(self, key: Hashable, build: Callable[[], Tuple]) -> Tuple:
        """build() returns a tuple of tensors / CsrPlans on this cache's
        device; so does get()."""
        if key in self._pinned:
            return self._pinned[key]
        if key in self._host:
            self.streamed_gets += 1
            return tuple(x.to(self.device, non_blocking=True)
                         for x in self._host[key])
        dev = tuple(build())
        size = _nbytes(dev)
        if self._used + size <= self.budget_bytes:
            self._pinned[key] = dev
            self._used += size
        elif self._host_used + size <= self.host_budget_bytes:
            # the first transfer rode the build: not a streamed get
            pin = self.device.type == "cuda"
            self._host[key] = tuple(_host_copy(x, pin) for x in dev)
            self._host_used += size
        else:
            self.streamed_gets += 1
            if key in self._seen:
                self.rebuilds += 1
        self._seen.add(key)
        return dev
