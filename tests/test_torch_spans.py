"""PyTorch port: the spans and counters of `utils/profiling.py` on the CPU.

Without a profiler session `span` is one shared no-op and `count` adds
nothing. Under `torch.profiler.profile` every span shows in the
profiler's events as `nerfail.<name>` and in `trace_record()` with its
parent and self times; `device_trace` starts each session on an empty
record. `train_nerf`, `nerfail_s_attack` and `extract_coord_maps` record
their spans once per step, batch and view, the plan cache counts what it
streams, and no number the program computes moves with the profiler on.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerfail_tpu_torch.config import (
    AttackConfig, ExperimentConfig, NeRFModelConfig, RenderConfig,
    TrainConfig,
)
from nerfail_tpu_torch.utils import profiling as prof

MODEL = dict(netdepth=2, netwidth=32, skips=(0,), multires=4,
             multires_views=2)
TRAIN_CHILDREN = {"train.batch", "train.render", "train.backward",
                  "train.adam", "train.log"}


@pytest.fixture(autouse=True)
def _fresh_record():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    prof.clear_record()
    yield
    prof.clear_record()
    torch.set_num_threads(prev)


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _names(rec):
    return [s["name"] for s in rec["spans"]]


def _children(rec, i):
    return [s for s in rec["spans"] if s["parent"] == i]


def test_off_is_one_shared_no_op():
    a, b = prof.span("a"), prof.span("b")
    assert a is b
    with a:
        prof.count("n", 3)
    prof.span_to_grad(torch.ones(2, requires_grad=True), "g")
    assert prof.trace_record() == {"spans": [], "counters": {}}


def test_spans_in_the_profilers_events_with_parents_and_self_times(tmp_path):
    with _session() as p:
        with prof.span("outer"):
            torch.randn(64, 64).sum()
            with prof.span("inner"):
                torch.randn(64, 64).sum()
            prof.count("n", 2)
            prof.count("n")
    names = {e.name() for e in p.profiler.kineto_results.events()}
    assert {"nerfail.outer", "nerfail.inner"} <= names
    rec = prof.trace_record()
    assert _names(rec) == ["outer", "inner"]
    outer, inner = rec["spans"]
    assert outer["parent"] is None and inner["parent"] == 0
    assert inner["host_ms"] < outer["host_ms"]
    assert outer["self_host_ms"] == pytest.approx(
        outer["host_ms"] - inner["host_ms"])
    assert inner["self_host_ms"] == inner["host_ms"]
    assert outer["device_ms"] is None          # no card
    assert rec["counters"] == {"n": 3}
    with prof.device_trace(str(tmp_path / "tr")):
        assert prof.trace_record() == {"spans": [], "counters": {}}
        with prof.span("again"):
            pass
    assert _names(prof.trace_record()) == ["again"]


def test_on_or_off_is_decided_when_a_span_is_entered():
    with prof.span("entered_off"):
        with _session():
            with prof.span("inside"):
                pass
    p = _session()
    p.__enter__()
    with prof.span("entered_on"):
        p.__exit__(None, None, None)
        with prof.span("after_stop"):
            pass
    rec = prof.trace_record()
    assert _names(rec) == ["inside", "entered_on"]
    assert rec["spans"][0]["parent"] is None


def _mini_nerf(i_print):
    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import make_box_scene

    cfg = ExperimentConfig(
        model=NeRFModelConfig(**MODEL),
        render=RenderConfig(N_samples=8, N_importance=8, chunk=256),
        train=TrainConfig(N_rand=64, precrop_iters=2, i_print=i_print))
    scene = make_box_scene(n_train=4, n_val=1, n_test=1, H=16, W=16)
    return cfg, scene, white_background_composite(scene.images)


def _train(cfg, scene, targets, n_iters, traced):
    from nerfail_tpu_torch.train.nerf_trainer import train_nerf

    logs = []
    run = lambda: train_nerf(  # noqa: E731
        cfg, targets, scene.poses, scene.K, scene.i_train, n_iters=n_iters,
        device="cpu", log_fn=lambda i, m: logs.append(m["loss"]))
    if traced:
        with _session():
            state = run()
    else:
        state = run()
    return state, logs


def test_train_nerf_records_a_step_with_its_five_children():
    cfg, scene, targets = _mini_nerf(i_print=1)
    _train(cfg, scene, targets, 3, traced=True)
    rec = prof.trace_record()
    steps = [i for i, s in enumerate(rec["spans"]) if s["name"] == "train.step"]
    assert len(steps) == 3
    for i in steps:
        kids = _children(rec, i)
        assert {s["name"] for s in kids} == TRAIN_CHILDREN
        # Adam twice a step: lr and zero_grad before the render, its step
        # after the backward
        assert [s["name"] for s in kids].count("train.adam") == 2
        assert rec["spans"][i]["self_host_ms"] >= 0


def test_train_losses_and_parameters_equal_with_the_profiler_on_and_off():
    cfg, scene, targets = _mini_nerf(i_print=1)
    off, logs_off = _train(cfg, scene, targets, 3, traced=False)
    on, logs_on = _train(cfg, scene, targets, 3, traced=True)
    assert logs_on == logs_off and len(logs_on) == 3
    for net in ("coarse", "fine"):
        for k, v in off.params[net].items():
            assert torch.equal(v, on.params[net][k]), (net, k)


def test_extract_coord_maps_records_views_and_gathers():
    from nerfail_tpu_torch.models.nerf import init_nerf_params
    from nerfail_tpu_torch.pointset.extract import extract_coord_maps

    _, scene, _ = _mini_nerf(i_print=1)
    mcfg = NeRFModelConfig(**MODEL)
    # 256 rays a view in chunks of 100
    cfg = ExperimentConfig(model=mcfg, render=RenderConfig(
        N_samples=8, N_importance=8, chunk=100))
    gen = torch.Generator().manual_seed(0)
    params = {"coarse": init_nerf_params(gen, mcfg, "cpu"),
              "fine": init_nerf_params(gen, mcfg, "cpu")}
    off = extract_coord_maps(params, cfg, scene.poses[:2], 16, 16, scene.K)
    with _session():
        on = extract_coord_maps(params, cfg, scene.poses[:2], 16, 16,
                                scene.K)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    rec = prof.trace_record()
    views = [i for i, s in enumerate(rec["spans"]) if s["name"] == "render.view"]
    assert len(views) == 2
    for i in views:
        assert [s["name"] for s in _children(rec, i)] == ["render.to_host"]


@pytest.fixture(scope="module")
def toy():
    jax = pytest.importorskip("jax")
    from tests.test_attack_mesh_e2e import _toy_attack_setup

    delta0, weights, idx, ori, labels, logits_fn = _toy_attack_setup(
        np.random.default_rng(0))
    Wc = np.asarray(logits_fn(jax.numpy.eye(8 * 8 * 3).reshape(
        -1, 8, 8, 3)))
    W = torch.from_numpy(np.array(Wc))
    return (delta0, weights, idx, ori, np.asarray(labels),
            lambda x: x.reshape(x.shape[0], -1) @ W)


def _attack(toy, cache, traced, epochs=2):
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack

    delta0, weights, idx, ori, labels, logits_fn = toy
    cfg = AttackConfig(eps=16.0, a=2.0, batch_size=2)
    run = lambda: nerfail_s_attack(  # noqa: E731
        delta0, weights, idx, ori, labels, logits_fn, cfg, resize_to=None,
        epochs=epochs, plan_cache=cache, device="cpu")
    if traced:
        with _session():
            return run()
    return run()


def _cache(budget, host_budget):
    from nerfail_tpu_torch.utils.device_cache import DeviceBudgetCache

    return DeviceBudgetCache(budget, host_budget_bytes=host_budget,
                             device="cpu")


@pytest.mark.parametrize("budget,host_budget,kind", [
    (1 << 30, 1 << 30, "device"), (0, 1 << 30, "streamed"), (0, 0, "rebuilt")])
def test_nerfail_s_records_a_step_a_batch_and_the_caches_counts(
        toy, budget, host_budget, kind):
    cache = _cache(budget, host_budget)
    _attack(toy, cache, traced=True)
    rec = prof.trace_record()
    n_batches = 3                     # 6 views in batches of 2
    names = _names(rec)
    assert names.count("attack.step") == 2 * n_batches
    assert names.count("attack.plan") == 2 * n_batches
    assert names.count("attack.epoch_end") == 2
    forwards = []
    for i, s in enumerate(rec["spans"]):
        if s["name"] == "attack.step":
            assert [c["name"] for c in _children(rec, i)] == [
                "attack.plan", "attack.forward", "attack.backward",
                "attack.update"]
        if s["name"] == "attack.forward":
            forwards.append([c["name"] for c in _children(rec, i)])
        if s["name"] == "attack.backward":
            assert [c["name"] for c in _children(rec, i)] == [
                "attack.classify_backward"]
    # epoch 0 classifies the clean views too; epoch 1 reuses their logits
    attacked = ["attack.splat", "attack.composite", "attack.resize",
                "attack.classify"]
    assert forwards == ([attacked + ["attack.resize", "attack.classify"]]
                        * n_batches + [attacked] * n_batches)
    c = dict(rec["counters"])
    assert (c.pop("attack.clean_logits_computed"),
            c.pop("attack.clean_logits_reused")) == (n_batches, n_batches)
    if kind != "streamed":
        assert c == {}
    else:
        from nerfail_tpu_torch.ops.cuda.segsum_kernel import CsrPlan

        def unbuilt():
            raise AssertionError("a host entry was built again")

        # each host entry's bytes, read with no session open
        sizes = [sum(x.nbytes if isinstance(x, CsrPlan) else
                     x.numel() * x.element_size()
                     for x in cache.get(s, unbuilt)) for s in (0, 2, 4)]
        assert c == {"plan_cache.streamed_gets": 3,
                     "plan_cache.streamed_bytes": sum(sizes)}
        assert sum(sizes) > 0


def test_nerfail_s_delta_equal_with_the_profiler_on_and_off(toy):
    off = _attack(toy, None, traced=False)
    on = _attack(toy, None, traced=True)
    np.testing.assert_array_equal(on.delta, off.delta)
    assert [h["attack_acc"] for h in on.history] == [
        h["attack_acc"] for h in off.history]
