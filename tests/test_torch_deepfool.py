"""PyTorch port, DeepFool: the engine (K1/K2's plain versions on the CPU)
and the DeepFool walks against the JAX package.

The fixture is the linear toy of tests/test_attacks.py: 8×8 views, a point
set from P = 2 mask views, 4 classes. Tolerances: the engine's logits, sq
and pick at rtol 1e-4 (fp32 sums in other orders, through a classifier);
iteration counts exactly; rot at rtol/atol 1e-4, as test_attacks.py holds
the batched walk to the per-view one.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.attacks.deepfool import (  # noqa: E402
    deepfool, deepfool_batch,
)
from nerfail_tpu_torch.attacks.forward import (  # noqa: E402
    composite_after_splat, resize_batch,
)
from nerfail_tpu_torch.attacks.nerfail import (  # noqa: E402
    make_batched_deepfool, make_view_logits_fn,
)
from nerfail_tpu_torch.config import AttackConfig  # noqa: E402
from nerfail_tpu_torch.ops.cuda.segsum_kernel import (  # noqa: E402
    build_batched_csr_plan,
)
from nerfail_tpu_torch.ops.splat import splat_deepfool_engine  # noqa: E402

H = W = 8
P = 2
C = 4  # classes
M = P * H * W


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _toy(seed, B, scale=1e-3):
    rng = np.random.default_rng(seed)
    weights = rng.uniform(0, 1, (B, H, W, 8)).astype(np.float32)
    weights /= weights.sum(-1, keepdims=True)
    idx = rng.integers(0, M, (B, H, W, 8)).astype(np.int32)
    ori = np.full((B, H, W, 4), 128.0, np.float32)
    ori[..., 3] = 255.0
    ori[:, 0, :3, 3] = 0.0                     # a few background pixels
    Wc = rng.standard_normal((H * W * 3, C)).astype(np.float32) * scale
    delta = np.zeros((P, H, W, 4), np.float32)
    delta[..., 3] = 255.0

    def j_logits(x):
        return x.reshape(x.shape[0], -1) @ jnp.asarray(Wc)

    tW = torch.from_numpy(Wc)

    def t_logits(x):
        return x.reshape(x.shape[0], -1) @ tW

    return dict(weights=weights, idx=idx, ori=ori, delta=delta,
                j_logits=j_logits, t_logits=t_logits)


def test_engine_matches_jax():
    """splat_deepfool_engine (logits, sq, pick(k)) against the JAX
    package's engine over its batched scatter plan (Pallas in interpret
    mode), on per-view point sets that differ."""
    from nerfail_tpu.attacks.forward import (
        composite_after_splat as j_comp, resize_batch as j_resize,
    )
    from nerfail_tpu.ops.pallas.segsum_kernel import (
        build_batched_scatter_plan,
    )
    from nerfail_tpu.ops.splat import splat_deepfool_engine as j_engine

    V = 2
    t = _toy(1, V, scale=1e-2)
    rng = np.random.default_rng(2)
    pts = np.broadcast_to(t["delta"].reshape(1, M, 4), (V, M, 4)).copy()
    pts[..., :3] = rng.uniform(-20, 20, (V, M, 3))
    ori_label = np.array([1, 3])
    k = np.array([2, 0])
    mask = t["ori"][..., 3:] > 0
    eps = 32.0

    jplan = build_batched_scatter_plan(t["idx"], t["weights"], M,
                                       pair_mask=mask)
    ori_j = jnp.asarray(t["ori"])

    def j_head(pix):
        return t["j_logits"](j_resize(j_comp(pix, ori_j, eps=eps)["cla_x"],
                                      None))

    jl, jsq, jpick = j_engine(j_head, jnp.asarray(pts), jnp.asarray(t["idx"]),
                              jnp.asarray(t["weights"]), jplan, C,
                              jnp.asarray(ori_label))
    jg = np.asarray(jpick(jnp.asarray(k)))

    ti = torch.from_numpy(t["idx"])
    tw = torch.from_numpy(t["weights"])
    ori_t = torch.from_numpy(t["ori"])
    plan = build_batched_csr_plan(ti, tw, M, pair_mask=ori_t[..., 3:] > 0)

    def t_head(pix):
        return t["t_logits"](resize_batch(
            composite_after_splat(pix, ori_t, eps=eps)["cla_x"], None))

    tl, tsq, tpick = splat_deepfool_engine(
        t_head, torch.from_numpy(pts), ti, tw, plan, C,
        torch.from_numpy(ori_label))
    tg = tpick(torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=1e-4)
    assert (tsq.numpy()[[0, 1], ori_label] == 0).all()
    assert tg.shape == (V, M, 4)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-8)
    assert np.abs(tg).max() > 0


@pytest.mark.parametrize("case", ["flip", "alpha", "max_iter"])
def test_deepfool_matches_jax_on_closed_forms(case):
    """tests/test_attacks.py TestDeepFool's three closed-form cases, run
    through both packages: same iterations, labels and δ."""
    from nerfail_tpu.attacks.deepfool import deepfool as j_deepfool

    if case == "flip":
        fns = (lambda d: jnp.stack([jnp.sum(d), -jnp.sum(d)]),
               lambda d: torch.stack([torch.sum(d), -torch.sum(d)]))
        d0 = np.full((4, 4, 4), -1.0, np.float32)
        kw = dict(max_iter=50, m1=0.0, m2=0.5, overshoot=1.0,
                  preserve_alpha=False)
    elif case == "alpha":
        fns = (lambda d: jnp.stack([jnp.sum(d[..., :3]), -jnp.sum(d[..., :3])]),
               lambda d: torch.stack([torch.sum(d[..., :3]),
                                      -torch.sum(d[..., :3])]))
        d0 = np.concatenate([np.full((2, 2, 3), -1.0), np.full((2, 2, 1),
                                                               77.0)], -1)
        d0 = d0.astype(np.float32)
        kw = dict(max_iter=50, m1=0.0, m2=0.5, overshoot=1.0)
    else:
        fns = (lambda d: jnp.array([1000.0, 0.0]) + 0.0 * jnp.sum(d),
               lambda d: torch.tensor([1000.0, 0.0]) + 0.0 * torch.sum(d))
        d0 = np.zeros((2, 2, 4), np.float32)
        kw = dict(max_iter=7)
    jr = j_deepfool(fns[0], jnp.asarray(d0), fns[0](jnp.asarray(d0)),
                    num_classes=2, **kw)
    t0 = torch.from_numpy(d0)
    tr = deepfool(fns[1], t0, fns[1](t0), num_classes=2, **kw)
    assert int(tr.iters) == int(jr.iters)
    assert int(tr.final_label) == int(jr.final_label)
    assert int(tr.ori_label) == int(jr.ori_label)
    np.testing.assert_allclose(tr.delta.numpy(), np.asarray(jr.delta),
                               rtol=1e-5, atol=1e-5)
    if case == "alpha":
        np.testing.assert_array_equal(tr.delta[..., 3].numpy(), 77.0)


@pytest.fixture(scope="module")
def batch_setup():
    """test_attacks.py's batched-vs-individual fixture: 3 views, m1 = 0,
    m2 = 0.2, df_max_iter = 5, with the clean logits of each view."""
    t = _toy(0, 3)
    cfg = AttackConfig(eps=32.0, m1=0.0, m2=0.2, df_max_iter=5)
    view_logits = make_view_logits_fn(t["t_logits"], cfg, None)
    d = torch.from_numpy(t["delta"])
    with torch.no_grad():
        ori_logits = torch.stack([
            view_logits(d, torch.from_numpy(t["weights"][v]),
                        torch.from_numpy(t["idx"][v]),
                        torch.from_numpy(t["ori"][v]))
            for v in range(3)])
    return t, cfg, ori_logits


def _df_batch(t, cfg, ori_logits, planned):
    B = t["idx"].shape[0]
    tw, ti = torch.from_numpy(t["weights"]), torch.from_numpy(t["idx"])
    ori = torch.from_numpy(t["ori"])
    plan = build_batched_csr_plan(ti, tw, M, pair_mask=ori[..., 3:] > 0)
    df = make_batched_deepfool(t["t_logits"], cfg, None, C,
                               accumulate_incomplete=True, planned=planned)
    return df(torch.from_numpy(t["delta"]), tw, ti, ori, ori_logits,
              torch.ones(B, dtype=torch.bool), cfg.m1, cfg.m2, plan)


def test_deepfool_single_view_matches_jax(batch_setup):
    from nerfail_tpu.attacks.deepfool import deepfool as j_deepfool
    from nerfail_tpu.attacks.nerfail import (
        make_view_logits_fn as j_view_logits_fn,
    )

    t, cfg, ori_logits = batch_setup
    jview = j_view_logits_fn(t["j_logits"], cfg, None)
    tview = make_view_logits_fn(t["t_logits"], cfg, None)
    for v in range(3):
        args = [t["weights"][v], t["idx"][v], t["ori"][v]]
        jr = j_deepfool(lambda d: jview(d, *map(jnp.asarray, args)),
                        jnp.asarray(t["delta"]),
                        jnp.asarray(ori_logits[v].numpy()), num_classes=C,
                        max_iter=cfg.df_max_iter, m1=cfg.m1, m2=cfg.m2,
                        overshoot=cfg.overshoot)
        tr = deepfool(lambda d: tview(d, *map(torch.from_numpy, args)),
                      torch.from_numpy(t["delta"]), ori_logits[v],
                      num_classes=C, max_iter=cfg.df_max_iter, m1=cfg.m1,
                      m2=cfg.m2, overshoot=cfg.overshoot)
        assert int(tr.iters) == int(jr.iters)
        assert int(tr.final_label) == int(jr.final_label)
        np.testing.assert_allclose(tr.rot.numpy(), np.asarray(jr.rot),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("planned", [True, False])
def test_batched_deepfool_matches_jax(batch_setup, planned):
    """make_batched_deepfool, engine path and generic-jacobian path,
    against the JAX package's batched walk: per-view iterations equal,
    summed rot close."""
    from nerfail_tpu.attacks.nerfail import (
        make_batched_deepfool as j_make,
    )

    t, cfg, ori_logits = batch_setup
    jdf = j_make(t["j_logits"], cfg, None, C, accumulate_incomplete=True)
    j_rot, j_iters, j_used, j_complete = jdf(
        jnp.asarray(t["delta"]), jnp.asarray(t["weights"]),
        jnp.asarray(t["idx"]), jnp.asarray(t["ori"]),
        jnp.asarray(ori_logits.numpy()), jnp.ones(3, bool), cfg.m1, cfg.m2)
    rot, iters, used, complete = _df_batch(t, cfg, ori_logits, planned)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(j_iters))
    np.testing.assert_array_equal(used.numpy(), np.asarray(j_used))
    np.testing.assert_array_equal(complete.numpy(), np.asarray(j_complete))
    np.testing.assert_allclose(rot.numpy(), np.asarray(j_rot), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(np.asarray(j_rot)).max() > 0


def test_engine_path_matches_generic_path(batch_setup):
    """Within the port: the K1/K2 engine and the generic per-class
    jacobian give the same walk."""
    t, cfg, ori_logits = batch_setup
    a = _df_batch(t, cfg, ori_logits, True)
    b = _df_batch(t, cfg, ori_logits, False)
    for x, y in zip(a[1:], b[1:]):            # iters, used, complete
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("max_iter", [1, 3, 50])
def test_loops_count_every_evaluation(max_iter):
    """loops = max over views of min(iters + 1, max_iter): the engine runs
    once more after the last step to see every view flipped, unless every
    unflipped view froze at max_iter; views that flip and views that
    never can share the batch."""
    # view v's logits: [s_v, -s_v]; view 2 is constant and never flips
    signs = torch.tensor([1.0, 1.0, 0.0])
    offs = torch.tensor([0.0, 0.0, 1000.0])

    def logits_fn_b(d):
        s = d.reshape(3, -1).sum(-1) * signs
        return torch.stack([s + offs, -s], dim=-1)

    d0 = torch.full((2, 2, 3), -1.0)
    d0_b = d0.expand(3, 2, 2, 3).clone()
    d0_b[1] *= 3.0                               # view 1 takes longer
    ori_logits = logits_fn_b(d0_b)

    calls = []

    def counting(d):
        calls.append(1)
        return logits_fn_b(d)

    # per-view starts: fold the view's factor into the logits instead
    scale = torch.tensor([1.0, 3.0, 1.0]).view(3, 1, 1, 1)
    res = deepfool_batch(lambda d: counting(d * scale), d0, ori_logits,
                         num_classes=2, max_iter=max_iter, m1=0.0, m2=0.5,
                         overshoot=0.3, preserve_alpha=False)
    iters = res.iters.numpy()
    assert iters[2] == max_iter                  # frozen, never flips
    assert res.loops == len(calls) == int(
        np.max(np.minimum(iters + 1, max_iter)))
    if max_iter == 50:
        assert iters[0] < iters[1] < max_iter
