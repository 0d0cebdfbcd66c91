"""PyTorch port: `DeviceBudgetCache.prefetch` on the CPU.

A prefetch sends a host copy to the card ahead of its get; on the CPU
there is no card and no copy stream, so it does nothing. For a key held
on the device, a key kept as a host copy, a key not built yet, a key
prefetched twice, and a prefetch dropped before its get, the gets after it
return what they return without it, and a profiler session records the
same counters.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerfail_tpu_torch.ops.cuda.segsum_kernel import build_csr_plan
from nerfail_tpu_torch.utils import profiling as prof
from nerfail_tpu_torch.utils.device_cache import DeviceBudgetCache


def _entry(key):
    g = torch.Generator().manual_seed(key)
    idx = torch.randint(0, 64, (1, 4, 4, 8), generator=g)
    w = torch.rand(1, 4, 4, 8, generator=g)
    return (w, idx, build_csr_plan(idx, w, 64))


def _flat(items):
    return [t for x in items
            for t in (x.tensors() if hasattr(x, "tensors") else (x,))]


def _run(budget, key, prefetches, drop=False):
    """Fill a cache with keys 0 and 1 (1 built second, past a device
    budget of one entry's bytes), then in a session prefetch `key` the
    given number of times, drop the prefetches if `drop`, and get it."""
    cache = DeviceBudgetCache(budget, device="cpu")
    for k in (0, 1):
        cache.get(k, lambda k=k: _entry(k))
    prof.clear_record()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(prefetches):
            cache.prefetch(key)
        if drop:
            cache.drop_prefetched()
        got = cache.get(key, lambda: _entry(key))
    counters = prof.trace_record()["counters"]
    prof.clear_record()
    return _flat(got), counters


@pytest.mark.parametrize("key,prefetches,drop,streamed", [
    (0, 1, False, False),   # held on the device
    (1, 1, False, True),    # a host copy
    (2, 1, False, False),   # not built yet: the get builds it
    (1, 2, False, True),    # a host copy prefetched twice
    (1, 1, True, True),     # a host copy prefetched, then dropped
], ids=["resident", "host", "unknown", "twice", "dropped"])
def test_prefetch_on_the_cpu_changes_no_get_and_no_counter(
        key, prefetches, drop, streamed):
    budget = sum(t.numel() * t.element_size() for t in _flat(_entry(0)))
    want, want_counters = _run(budget, key, 0)
    got, counters = _run(budget, key, prefetches, drop)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "cpu"
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert counters == want_counters
    assert ("plan_cache.streamed_gets" in counters) == streamed
    assert "plan_cache.prefetched_gets" not in counters
