"""The trace reduction on events made by hand."""

import torch

from benchmark.trace import WINDOW, reduce_events

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, tid=1):
        self._n, self._d, self._s, self._u, self._t = name, dev, start, dur, tid

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._n.startswith("Optimizer") and self._d == CPU


def test_reduction():
    ev = [Ev(WINDOW, CPU, 0, 1000),
          Ev("host_step", CPU, 0, 1000), Ev("aten::item", CPU, 600, 200),
          Ev("Optimizer.step", CPU, 0, 10),
          Ev(WINDOW, CUDA, 0, 1000), Ev("Optimizer.step", CUDA, 0, 900),
          Ev("void (anonymous namespace)::kernel_a<256>(Dims, int)", CUDA,
             100, 200),
          Ev("kernel_b", CUDA, 250, 150),
          Ev("Memcpy HtoD", CUDA, 500, 100), Ev("kernel_a", CUDA, 900, 300)]
    s = reduce_events(ev)
    assert s.window_s == 1e-6
    # kernels cover 100-400 and 900-1000; the copy 500-600
    assert abs(s.kernel_s - 400e-9) < 1e-15
    assert abs(s.busy_s - 500e-9) < 1e-15
    assert s.launches["kernel_a"] == 2
    assert abs(s.seconds_of("kernel_a") - 300e-9) < 1e-15
    # gaps 0-100 (host_step), 400-900 (middle 650: aten::item)
    assert abs(s.idle_by_host["aten::item"] - 500e-9) < 1e-15
    assert abs(s.idle_by_host["host_step"] - 100e-9) < 1e-15
    b = s.breakdown()
    assert b["device_ops"][0][0] == "kernel_a" and len(b["idle_gaps"]) == 2


def test_short_name():
    from benchmark.trace import short_name

    assert short_name("void (anonymous namespace)::mlp_fwd_ws_kernel<256>("
                      "(anonymous namespace)::Dims, int)") == \
        "mlp_fwd_ws_kernel"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
