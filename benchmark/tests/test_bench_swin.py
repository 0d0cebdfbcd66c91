"""The Swin-B cell: its files resolve, a cut-down run on the CPU reads
correct, the port with its shift masks dropped does not, nor the port
with a classifier backward 1 % off, nor a step with a planted fault
(`faults.attack_step_fault`), a traced run counts K1's bytes, the
reference leaves the TF32 flags as it found them, its FLOP count agrees
with a count by hand, and its readers read the program's spans and
counters. On the card (`-m gpu`): the program's readings pass the
limits, the TF32 control fails `logit_gap` and `grad_gap`, and the
control with TF32 in the classifier's backward alone fails `grad_gap`."""

import contextlib

import pytest
import torch

from benchmark import faults, harness
from benchmark import run as bench_run
from benchmark.counts import swin as counts
from benchmark.drivers import nerfail_s_swin
from benchmark.reference import swin_b as ref_swin
from benchmark.tests.tiny import SEED, tiny_cell
from nerfail_tpu_torch.models.classifiers import swin
from nerfail_tpu_torch.utils import profiling

CELL = "swin_b_299.nerfail_s_400v"
METRICS = {"mfu.swin_nerfail_s", "idle_share.swin_nerfail_s",
           "classifier_share.swin_nerfail_s", "attn_share.swin_nerfail_s",
           "pad_share.swin_nerfail_s"}
# metrics of the NeRFail-S cells that read what is not the classifier's
SHARED = {"k1_roofline.nerfail_s", "plan_wait_share.nerfail_s",
          "plan_stream_gb.nerfail_s"}
CHECKS = ["step_sign_miss", "knn_dist_gap", "knn_weight_gap", "logit_gap",
          "grad_gap"]
NARROW = dict(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[2, 4, 8, 16])


def test_cell_resolves():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.workload["engine"] == "nerfail_s_swin"
    assert {m["name"] for m in cell.end_to_end} == {
        "nerfail_s_views_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == METRICS | SHARED
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]).read)
    assert set(cell.workload["limits"]) == set(CHECKS)
    c = cell.config["classifier"]
    assert (c["embed_dim"], c["depths"], c["num_heads"], c["window"],
            c["mlp_ratio"], c["input_size"]) == (
        128, [2, 2, 18, 2], [4, 8, 16, 32], 7, 4.0, 299)
    assert cell.config["reduced"] == []
    inception = harness.load_cell("inception_v3_800.nerfail_s_400v")
    for k in ("scene", "pointset", "attack", "plan_device_budget"):
        assert cell.config[k] == inception.config[k]
    assert cell.workload["traffic"] == inception.workload["traffic"]


@pytest.fixture
def tiny(monkeypatch):
    """The cell at tiny_cell's cuts with Swin-B narrowed and kept at 299²,
    so that every stage pads and two merges meet odd sides."""
    cell = tiny_cell(CELL)
    cell.config["classifier"].update(input_size=299, **NARROW)
    monkeypatch.setattr(harness, "load_cell",
                        lambda name, root=harness.ROOT: cell)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _line():
    args = bench_run.parse(["--workload", CELL, "--seed", str(SEED),
                            "--seconds", "0.2", "--trace", "0"])
    line, _ = bench_run.run_cell(args, torch.device("cpu"))
    return line


def test_tiny_run_is_correct(tiny):
    line = _line()
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"nerfail_s_views_per_s", "setup_s"}
    assert list(line["checks"]) == CHECKS


@contextlib.contextmanager
def shift_masks_dropped():
    """The port's window attention without its shift masks."""
    forward = swin.WindowAttention.forward
    swin.WindowAttention.forward = lambda self, x, mask=None: forward(
        self, x, None)
    try:
        yield
    finally:
        swin.WindowAttention.forward = forward


def test_dropped_shift_masks_are_caught(tiny):
    with shift_masks_dropped():
        line = _line()
    assert not line["correct"]
    gap = line["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


class GradScaled(torch.autograd.Function):
    """The identity forward; a backward 1 % off."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * 1.01


@contextlib.contextmanager
def classifier_backward_off():
    """The port's Swin-B with logits as they are and an input gradient 1 %
    off: no sign of the step moves, so only `grad_gap` can see it."""
    forward = swin.SwinB.forward
    swin.SwinB.forward = lambda self, x: GradScaled.apply(forward(self, x))
    try:
        yield
    finally:
        swin.SwinB.forward = forward


def test_classifier_backward_off_is_caught(tiny):
    with classifier_backward_off():
        line = _line()
    assert not line["correct"]
    checks = line["checks"]
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]
    for name in CHECKS[:-1]:
        assert checks[name]["value"] <= checks[name]["limit"], name


@pytest.mark.parametrize("kind", ["altered", "half"])
def test_attack_step_faults_are_caught(tiny, kind):
    with faults.attack_step_fault(kind):
        line = _line()
    assert not line["correct"]
    miss = line["checks"]["step_sign_miss"]
    assert miss["value"] > miss["limit"]


class NoTracer:
    def start(self):
        pass

    def stop(self):
        pass


def test_traced_run_counts_k1_bytes(tiny):
    ctx = harness.Context(harness.load_cell(CELL), SEED, 0.2,
                          torch.device("cpu"))
    nerfail_s_swin.measure(ctx, NoTracer())
    assert ctx.stats["epochs"] == 1 and ctx.stats["k1_bytes"] > 0


def test_reference_restores_tf32_flags():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for on in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on
            model = ref_swin.SwinB(8, 75, window=7, **NARROW).eval()
            with torch.no_grad():
                model(torch.zeros(1, 75, 75, 3))
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (on, on)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_forward_flops_by_hand():
    c = dict(num_classes=8, input_size=299, window=7, mlp_ratio=4.0,
             **NARROW)
    # stages: (side, padded side, width); 4 heads' products sum to C
    stages = [(74, 77, 32), (37, 42, 64), (19, 21, 128), (10, 14, 256)]
    total = 2 * 74 * 74 * 32 * 48                         # patch embedding
    for h, p, w in stages:
        qkv, proj = 2 * p * p * w * 3 * w, 2 * p * p * w * w
        attn = 2 * 2 * p * p * 49 * w                     # q.k^T, attn.v
        mlp = 2 * 2 * h * h * w * 4 * w
        total += 2 * (qkv + attn + proj + mlp)
    for h, _, w in stages[1:]:
        total += 2 * h * h * 4 * (w // 2) * w              # merges
    total += 2 * 256 * 8                                  # head
    assert counts.classifier_forward_flops(c) == total


def test_view_flops_of_the_cell():
    cfg = harness.load_cell(CELL).config
    fwd = counts.classifier_forward_flops(cfg["classifier"])
    assert 62.0e9 < fwd < 62.5e9
    assert counts.nerfail_s_view_flops(cfg) > 2 * fwd


class Run:
    summary = object()          # a traced run
    stats: dict = {}


def _span(name, parent, device_ms):
    return {"name": name, "parent": parent, "host_ms": 1.0,
            "device_ms": device_ms}


RECORD = {"spans": [_span("attack.step", None, 100.0),
                    _span("attack.forward", 0, 60.0),
                    _span("attack.classify", 1, 30.0),
                    _span("swin.attention", 2, 12.0),
                    _span("swin.mlp", 2, 10.0),
                    _span("attack.classify", 1, 20.0),
                    _span("swin.attention", 5, 8.0),
                    _span("attack.backward", 0, 30.0),
                    _span("attack.classify_backward", 7, 25.0)],
          "counters": {"swin.qkv_rows": 400, "swin.pad_rows": 56}}


@pytest.mark.parametrize("name,value", [
    ("classifier_share.swin_nerfail_s", 75.0),
    ("attn_share.swin_nerfail_s", 40.0),
    ("pad_share.swin_nerfail_s", 14.0)])
def test_readers_on_a_record(monkeypatch, name, value):
    monkeypatch.setattr(profiling, "trace_record", lambda: RECORD)
    assert harness.reader(name).read(Run()) == pytest.approx(value)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_readers_on_nothing(monkeypatch, name):
    read = harness.reader(name).read
    untraced = Run()
    untraced.summary = None
    monkeypatch.setattr(profiling, "trace_record", lambda: RECORD)
    assert read(untraced) is None
    if name.startswith(("mfu", "idle")):
        return
    # a program without Swin's spans and counters, or without a record
    bare = {"spans": [s for s in RECORD["spans"]
                      if not s["name"].startswith("swin.")], "counters": {}}
    if name.startswith("classifier_share"):
        bare = {"spans": [], "counters": {}}
    monkeypatch.setattr(profiling, "trace_record", lambda: bare)
    assert read(Run()) is None
    monkeypatch.delattr(profiling, "trace_record")
    assert read(Run()) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("control", [False, True, "backward"])
def test_limits_separate_on_the_card(card, control):
    from benchmark import controls_swin

    cell = harness.load_cell(CELL)
    ctx = harness.Context(cell, 3_000_000_777, 0.0, card)
    got = controls_swin.readings(ctx, control)
    limits = {k: float(v) for k, v in cell.workload["limits"].items()}
    assert (got["logit_gap"] > limits["logit_gap"]) == (control is True)
    assert (got["grad_gap"] > limits["grad_gap"]) == bool(control)
    if not control:
        assert all(got[k] <= v for k, v in limits.items())
