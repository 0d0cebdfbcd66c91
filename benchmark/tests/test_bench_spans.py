"""The readers of the program's spans and counters on records made by
hand, and None where the record holds nothing."""

import pytest

from benchmark import harness, spans
from nerfail_tpu_torch.utils import profiling


class Run:
    summary = object()          # a traced run


def _span(name, parent, host_ms, device_ms):
    return {"name": name, "parent": parent, "host_ms": host_ms,
            "device_ms": device_ms}


TRAIN = {"spans": [_span("train.step", None, 14.0, 9.0),
                   _span("train.render", 0, 5.0, 3.0),
                   _span("train.step", None, 20.0, 9.0),
                   _span("train.step", None, 15.0, 9.0)],
         "counters": {}}
ATTACK = {"spans": [_span("attack.step", None, 50.0, 60.0),
                    _span("attack.plan", 0, 1.0, 6.0),
                    _span("attack.forward", 0, 20.0, 20.0),
                    _span("attack.classify", 2, 5.0, 8.0),
                    _span("attack.classify", 2, 5.0, 4.0),
                    _span("attack.backward", 0, 20.0, 30.0),
                    _span("attack.classify_backward", 5, 10.0, 12.0),
                    _span("attack.step", None, 50.0, 40.0),
                    _span("attack.plan", 7, 1.0, 4.0),
                    _span("attack.epoch_end", None, 400.0, 1.0)],
          "counters": {"plan_cache.streamed_bytes": 3 * 10 ** 9,
                       "plan_cache.streamed_gets": 2}}
EMPTY = {"spans": [], "counters": {}}

CASES = [("step_host_ms.train", TRAIN, 15.0),
         ("plan_wait_share.nerfail_s", ATTACK, 10.0),
         ("classifier_share.nerfail_s", ATTACK, 24.0),
         ("plan_stream_gb.nerfail_s", ATTACK, 3.0)]


@pytest.mark.parametrize("name,rec,value", CASES)
def test_reader_on_a_record(monkeypatch, name, rec, value):
    monkeypatch.setattr(profiling, "trace_record", lambda: rec)
    assert harness.reader(name).read(Run()) == pytest.approx(value)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_on_nothing(monkeypatch, name):
    read = harness.reader(name).read
    monkeypatch.setattr(profiling, "trace_record", lambda: EMPTY)
    assert read(Run()) is None
    untraced = Run()
    untraced.summary = None
    monkeypatch.setattr(profiling, "trace_record", lambda: ATTACK)
    assert read(untraced) is None
    # a program that keeps no record
    monkeypatch.delattr(profiling, "trace_record")
    assert read(Run()) is None


def test_no_device_times_read_none():
    rec = {"spans": [_span("attack.step", None, 5.0, None),
                     _span("attack.plan", 0, 1.0, None)], "counters": {}}
    assert spans.device_share(rec, ("attack.plan",), "attack.step") is None


def test_nothing_streamed_reads_zero():
    rec = {"spans": [_span("attack.epoch_end", None, 1.0, 1.0)],
           "counters": {}}
    assert spans.per_span(rec, "plan_cache.streamed_bytes",
                          "attack.epoch_end") == 0
