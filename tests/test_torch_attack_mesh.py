"""PyTorch port, multi-GPU: both 3D attack control planes sharded over 2
gloo ranks, against the port's single process and the JAX package's mesh.

The inputs are tests/test_attack_mesh_e2e.py's `_toy_attack_setup` (6
views at 8², a linear classifier); the JAX runs use its
make_mesh(2, model_parallel=1). As there, sharding must be a pure
execution detail: the control-plane histories are equal and δ agrees at
rtol 1e-4, atol 1e-3 (sums over views in another order; a sign step turns
on the gradient's sign). δ is bit-equal across the ranks: every rank
steps on the same all-reduced gradient. NeRFail's view batch 1 rounds up
to 2 over the 2-rank data axis, so the single-process runs use 2.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from nerfail_tpu_torch.attacks.nerfail import nerfail_attack  # noqa: E402
from nerfail_tpu_torch.attacks.nerfail_s import (  # noqa: E402
    nerfail_s_attack,
)
from nerfail_tpu_torch.config import AttackConfig  # noqa: E402
from nerfail_tpu_torch.parallel.launch import spawn  # noqa: E402
from nerfail_tpu_torch.tools import parallel_checks as pc  # noqa: E402
from tests.test_attack_mesh_e2e import _toy_attack_setup  # noqa: E402

CFG_S = dict(eps=16.0, a=2.0, batch_size=2, attack_epochs=3)
CFG_N = dict(eps=16.0, m1=8.0, m2=100.0, view_batch=1, df_max_iter=8,
             attack_epochs=2)
CFG_N1 = dict(CFG_N, view_batch=2)
KEYS = ("epoch", "m1", "m2", "attack_acc", "deepfool_calls")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def toy():
    delta0, weights, idx, ori, labels, logits_fn = _toy_attack_setup(
        np.random.default_rng(0))
    Wc = np.asarray(logits_fn(jax.numpy.eye(8 * 8 * 3).reshape(
        -1, 8, 8, 3)))
    return (delta0, weights, idx, ori, np.asarray(labels), Wc), logits_fn


@pytest.fixture(scope="module")
def sharded(toy, tmp_path_factory):
    root = tmp_path_factory.mktemp("attack_mesh")
    out = spawn(pc.attack_mesh_runs, 2, backend="gloo", store_dir=str(root),
                device_type="cpu", model_parallel=1,
                args=(toy[0], CFG_S, CFG_N, str(root / "out")),
                num_threads=1)
    return out, root / "out"


def _single(toy, engine):
    delta0, weights, idx, ori, labels, Wc = toy[0]
    logits_fn = pc.linear_logits_fn(Wc, "cpu")
    if engine == "nerfail_s":
        return nerfail_s_attack(delta0, weights, idx, ori, labels, logits_fn,
                                AttackConfig(**CFG_S), resize_to=None,
                                device="cpu")
    return nerfail_attack(delta0, weights, idx, ori, logits_fn,
                          AttackConfig(**CFG_N1), resize_to=None, epochs=2,
                          device="cpu")


def _jax_mesh(toy, engine):
    from nerfail_tpu.attacks.nerfail import nerfail_attack as j_nerfail
    from nerfail_tpu.attacks.nerfail_s import nerfail_s_attack as j_s
    from nerfail_tpu.config import AttackConfig as JA
    from nerfail_tpu.parallel.mesh import make_mesh

    delta0, weights, idx, ori, labels, _ = toy[0]
    mesh = make_mesh(2, model_parallel=1)
    if engine == "nerfail_s":
        return j_s(delta0, weights, idx, ori, labels, toy[1], JA(**CFG_S),
                   resize_to=None, planned=True, mesh=mesh)
    return j_nerfail(delta0, weights, idx, ori, toy[1], JA(**CFG_N),
                     resize_to=None, epochs=2, planned=True, mesh=mesh)


def _history(engine, history):
    keys = ("epoch", "attack_acc", "clean_acc") if engine == "nerfail_s" \
        else KEYS
    return [{k: h[k] for k in keys} for h in history]


@pytest.mark.parametrize("engine", ["nerfail_s", "nerfail"])
def test_delta_is_the_same_on_every_rank(sharded, engine):
    out, _ = sharded
    np.testing.assert_array_equal(out[0][engine]["delta"],
                                  out[1][engine]["delta"])
    assert out[0][engine]["history"] == [
        {**h, "time_s": g["time_s"]} for h, g in
        zip(out[1][engine]["history"], out[0][engine]["history"])]


@pytest.mark.parametrize("engine", ["nerfail_s", "nerfail"])
def test_sharded_attack_matches_single_process(sharded, toy, engine):
    out, _ = sharded
    ref = _single(toy, engine)
    got = out[0][engine]
    assert _history(engine, got["history"]) == _history(engine, ref.history)
    if engine == "nerfail":
        assert [h["deepfool_iters"] for h in got["history"]] == \
            [h["deepfool_iters"] for h in ref.history]
    assert got["best_attack_acc"] == ref.best_attack_acc
    np.testing.assert_allclose(got["delta"], ref.delta, rtol=1e-4,
                               atol=1e-3)


def test_sharded_attack_classifies_clean_views_once(sharded, toy):
    """The sharded NeRFail-S run keeps each rank's clean logits of every
    batch from the first epoch: epochs × batches + batches classifier calls
    on each rank (its history, clean accuracy included, is held to the
    single process's by test_sharded_attack_matches_single_process)."""
    out, _ = sharded
    n_batches = -(-len(toy[0][4]) // CFG_S["batch_size"])
    want = CFG_S["attack_epochs"] * n_batches + n_batches
    assert [out[r]["nerfail_s"]["classify_calls"] for r in (0, 1)] == \
        [want, want]


@pytest.mark.parametrize("engine", ["nerfail_s", "nerfail"])
def test_sharded_attack_matches_jax_mesh(sharded, toy, engine):
    out, _ = sharded
    ref = _jax_mesh(toy, engine)
    got = out[0][engine]
    keys = ("epoch", "attack_acc") if engine == "nerfail_s" else KEYS
    assert [{k: h[k] for k in keys} for h in got["history"]] == \
        [{k: h[k] for k in keys} for h in ref.history]
    np.testing.assert_allclose(got["delta"], np.asarray(ref.delta),
                               rtol=1e-4, atol=1e-3)


def test_one_sharded_step_equals_one_process_step(sharded, toy):
    """make_nerfail_s_step over the ranks' halves of one 6-view batch: the
    reduced gradient's sign step, the same δ on both ranks and as one
    process's step over the whole batch."""
    from nerfail_tpu_torch.attacks.nerfail_s import make_nerfail_s_step
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import build_csr_plan

    out, _ = sharded
    delta0, weights, idx, ori, labels, Wc = toy[0]
    step = make_nerfail_s_step(pc.linear_logits_fn(Wc, "cpu"),
                               AttackConfig(**CFG_S), None)
    w, i, o = (torch.from_numpy(a) for a in (weights, idx, ori))
    plan = build_csr_plan(i, w, delta0.reshape(-1, 4).shape[0],
                          pair_mask=o[..., 3:] > 0)
    d0 = torch.from_numpy(delta0)
    new, m = step(d0, d0, w, i, o, torch.from_numpy(labels),
                  torch.ones(len(labels)), plan)
    np.testing.assert_array_equal(out[0]["step"]["delta"],
                                  out[1]["step"]["delta"])
    np.testing.assert_allclose(out[0]["step"]["delta"], new.numpy(),
                               rtol=1e-4, atol=1e-3)
    assert np.abs(new.numpy() - delta0).max() > 0          # δ moved


def test_pipeline_stage_attack_on_a_mesh(sharded, toy):
    """Pipeline.stage_attack with a mesh: NeRFail-S sharded and IGSM-2D on
    rank 0, the same result on both ranks, each artifact written once and
    no attack state left behind."""
    out, root = sharded
    for method in ("NeRFail_S", "IGSM_2D"):
        np.testing.assert_array_equal(out[0][method]["delta"],
                                      out[1][method]["delta"])
    from nerfail_tpu_torch.config import scene_class_index

    delta0, weights, idx, ori, _, Wc = toy[0]
    labels = np.full(len(ori), scene_class_index("chair"))
    ref = nerfail_s_attack(delta0, weights, idx, ori, labels,
                           pc.linear_logits_fn(Wc, "cpu"),
                           AttackConfig(method="NeRFail_S", **CFG_S),
                           resize_to=None, epochs=1, device="cpu")
    np.testing.assert_allclose(out[0]["NeRFail_S"]["delta"], ref.delta,
                               rtol=1e-4, atol=1e-3)
    for method, name in (("NeRFail_S", "delta.npy"),
                         ("IGSM_2D", "delta.npy")):
        found = sorted(root.glob(f"toy/attack/chair/{method}_*"))
        assert len(found) == 1, method
        d = found[0]
        assert (d / name).exists() and (d / "test" / "r_0.png").exists()
        assert not (d / "attack_state.npz").exists()
        np.testing.assert_array_equal(np.load(d / name),
                                      out[0][method]["delta"])
