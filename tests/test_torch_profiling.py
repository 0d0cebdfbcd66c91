"""PyTorch port, slice 11: utils/profiling.py against the JAX package's.

The analytic FLOP counts equal the JAX package's exactly (the same
integer arithmetic); `fence`, `timed` and `device_trace` run on the CPU;
`roofline_of` places given work against given peaks exactly (the
quotients below are computed the same way); a card without published
peaks raises unless `peaks` is passed. Times here are CPU wall times and
are only checked to be positive.
"""

import json
import os

import pytest
import torch

jax = pytest.importorskip("jax")

from nerfail_tpu.config import NeRFModelConfig as JM  # noqa: E402
from nerfail_tpu.config import RenderConfig as JR  # noqa: E402
from nerfail_tpu.utils import profiling as jprof  # noqa: E402
from nerfail_tpu_torch.config import (  # noqa: E402
    NeRFModelConfig, RenderConfig,
)
from nerfail_tpu_torch.utils import profiling as prof  # noqa: E402

MODELS = [dict(), dict(netdepth=2, netwidth=32, skips=(0,), multires=4,
                       multires_views=2),
          dict(netdepth=4, netwidth=128, use_viewdirs=False),
          dict(netdepth=8, netwidth=256, skips=(2, 5), multires=6)]


@pytest.mark.parametrize("kw", MODELS)
def test_flop_counts_equal_the_jax_package(kw):
    assert (prof.nerf_mlp_flops_per_point(NeRFModelConfig(**kw))
            == jprof.nerf_mlp_flops_per_point(JM(**kw)))
    for rkw, n_rand in ((dict(), 1024), (dict(N_samples=32,
                                              N_importance=0), 512)):
        assert (prof.nerf_train_step_flops(NeRFModelConfig(**kw),
                                           RenderConfig(**rkw), n_rand)
                == jprof.nerf_train_step_flops(JM(**kw), JR(**rkw), n_rand))


def test_fence_timed_and_trace_run_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    prof.fence(x)
    prof.fence({"a": [x, 1.0]})
    prof.fence(None)
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a

    secs = prof.timed(fn, x, iters=5, warmup=2)
    assert secs > 0 and len(calls) == 7
    with prof.device_trace(str(tmp_path / "tr")) as p:
        (x @ x).sum()
    path = tmp_path / "tr" / "trace.json"
    assert os.path.exists(path)
    assert "traceEvents" in json.loads(path.read_text())
    assert any("mm" in e.key for e in p.key_averages())


def test_roofline_arithmetic():
    peaks = prof.Peaks(bytes_per_s=2e12, fp32=50e12, bf16=800e12)
    r = prof.roofline_of(2e-3, flops=8e11, bytes_accessed=1e9,
                         peak_flops=peaks.bf16, peak_bytes=peaks.bytes_per_s)
    assert r.bound == "operations" and r.bound_seconds == 8e11 / 800e12
    assert r.tflops_per_s == 8e11 / 2e-3 / 1e12
    assert r.gbytes_per_s == 1e9 / 2e-3 / 1e9
    assert r.flops_utilization == (8e11 / 800e12) / 2e-3
    assert r.hbm_utilization == (1e9 / 2e12) / 2e-3
    r = prof.roofline_of(1e-3, flops=1e6, bytes_accessed=4e9,
                         peak_flops=peaks.fp32, peak_bytes=peaks.bytes_per_s)
    assert r.bound == "bytes" and r.bound_seconds == 4e9 / 2e12
    assert "bound" in str(r)
    # measured: the time comes from `timed`, the peaks from the caller
    x = torch.randn(32, 32)
    r = prof.roofline(lambda a: a @ a, x, flops=2 * 32 ** 3,
                      bytes_accessed=3 * 32 * 32 * 4, dtype="fp32",
                      peaks=peaks, iters=3, warmup=1)
    assert r.seconds > 0 and r.bound_seconds == max(
        2 * 32 ** 3 / peaks.fp32, 3 * 32 * 32 * 4 / peaks.bytes_per_s)


def test_peaks_by_card_name(monkeypatch):
    """The H100 SXM's data-sheet peaks by its name; another card without
    `peaks` raises, and a CPU call without `peaks` has no card to ask."""
    assert prof.PEAKS["NVIDIA H100 80GB HBM3"] == prof.H100_SXM
    assert (prof.H100_SXM.bytes_per_s, prof.H100_SXM.fp32,
            prof.H100_SXM.bf16) == (3.35e12, 67e12, 989e12)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert prof.card_peaks(0) is prof.H100_SXM
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other GPU")
    with pytest.raises(KeyError, match="Some Other GPU"):
        prof.card_peaks(0)
    with pytest.raises(ValueError, match="peaks="):
        prof.roofline(lambda a: a, torch.zeros(1), flops=1.0,
                      bytes_accessed=1.0)
