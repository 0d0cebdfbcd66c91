"""PyTorch port, slice 1 as a whole: NeRFail-S on 8-NN tables vs JAX.

Both packages get the same numpy inputs: a 32² box scene, tables from the
exact KD-tree, and a SimpleCNN whose flax weights are carried into the
port. The attack takes sign(∂loss/∂δ), so fp differences in the backward
can flip entries whose gradient is near zero (ROADMAP Queue 3 "Sign
ties"): one step may differ on < 0.5 % of RGB entries, each difference a
multiple of the step a; two epochs must agree on ≥ 99 % of entries.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.attacks.forward import (  # noqa: E402
    make_classifier_logits_fn,
)
from nerfail_tpu_torch.attacks.nerfail_s import (  # noqa: E402
    make_nerfail_s_step, nerfail_s_attack,
)
from nerfail_tpu_torch.config import AttackConfig  # noqa: E402
from nerfail_tpu_torch.models.classifiers.convert import (  # noqa: E402
    load_flax_variables,
)
from nerfail_tpu_torch.models.classifiers.simple_cnn import (  # noqa: E402
    SimpleCNN,
)

H = 32
N_VIEWS = 6
MASK_VIEWS = [0, 3]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    from nerfail_tpu.attacks.forward import (
        make_classifier_logits_fn as j_logits_fn,
    )
    from nerfail_tpu.data.synthetic import analytic_coord_map, make_box_scene
    from nerfail_tpu.models.classifiers.simple_cnn import SimpleCNN as J
    from nerfail_tpu.pointset.knn_build import knn_host_tree
    from nerfail_tpu.pointset.weights import gauss_weights

    sc = make_box_scene(n_train=N_VIEWS, n_val=0, n_test=0, H=H, W=H,
                        seed=4)
    S = np.concatenate([analytic_coord_map(sc.poses[v], H, H, sc.K)
                        .reshape(-1, 3) for v in MASK_VIEWS])
    wts, idxs = [], []
    for v in range(N_VIEWS):
        cm = analytic_coord_map(sc.poses[v], H, H, sc.K)
        d, i = knn_host_tree(cm.reshape(-1, 3), S, k=8)
        wts.append(np.asarray(gauss_weights(jnp.asarray(d), c=0.02 * 800 / H))
                   .reshape(H, H, 8))
        idxs.append(i.reshape(H, H, 8))
    ori = np.concatenate([sc.images[..., :3] * 255.0,
                          sc.images[..., 3:] * 255.0], -1).astype(np.float32)
    delta0 = ori[MASK_VIEWS].copy()
    delta0[..., :3] = 0.0

    jmodel = J(num_classes=8)
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(1), jnp.zeros((1, H, H, 3)), train=False))
    tmodel = load_flax_variables(SimpleCNN(num_classes=8), variables)
    # labels: the classifier's own clean predictions on half the views,
    # another class on the rest, so both accuracies are non-trivial
    clean = np.where(ori[..., 3:] > 0, ori[..., :3], 255.0)
    preds = np.argmax(np.asarray(jmodel.apply(variables, jnp.asarray(clean))),
                      -1)
    labels = np.where(np.arange(N_VIEWS) % 2 == 0, preds, (preds + 1) % 8)
    return dict(
        wts=np.stack(wts), idxs=np.stack(idxs), ori=ori, delta0=delta0,
        labels=labels.astype(np.int64), clean=clean,
        j_logits=j_logits_fn(jmodel, variables["params"], {}),
        t_logits=make_classifier_logits_fn(tmodel),
    )


def _assert_sign_step_agreement(t, j, a, max_flip):
    diff = t - j
    steps = diff / a
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-4)
    assert np.mean(diff[..., :3] != 0) < max_flip
    np.testing.assert_array_equal(t[..., 3], j[..., 3])


def test_one_step_matches_jax(setup):
    from nerfail_tpu.attacks.nerfail_s import make_nerfail_s_step as j_step
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import build_csr_plan

    su = setup
    cfg = AttackConfig(eps=32.0, a=2.0, batch_size=4)
    ids = np.arange(4)
    valid = np.array([1, 1, 1, 0], np.float32)      # ragged-tail mask
    args = (su["wts"][ids], su["idxs"][ids], su["ori"][ids],
            su["labels"][ids], valid)
    jd, jm = j_step(su["j_logits"], cfg, None, planned=False)(
        jnp.asarray(su["delta0"]), jnp.asarray(su["delta0"]),
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    plan = build_csr_plan(targs[1], targs[0], su["delta0"].size // 4,
                          pair_mask=targs[2][..., 3:] > 0)
    d0 = torch.from_numpy(su["delta0"])
    td, tm = make_nerfail_s_step(su["t_logits"], cfg, None)(
        d0, d0, *targs, plan)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    for key in ("attacked_correct", "clean_correct"):
        assert float(tm[key]) == float(jm[key])
    _assert_sign_step_agreement(td.numpy(), np.asarray(jd), cfg.a, 0.005)


@pytest.mark.parametrize("ids, valid, resize_to", [
    ([0, 1, 2, 3], [1, 1, 1, 0], None),
    ([4, 5, 5, 5], [1, 1, 0, 0], 16),
])
def test_step_given_clean_logits_is_the_same_step(setup, ids, valid,
                                                  resize_to):
    """A step built with a clean-logit memo keeps the batch's clean logits
    on its first step and classifies only the attacked views on the next,
    and makes the same δ, loss and counts as a step built without it."""
    from nerfail_tpu_torch.attacks.nerfail_s import CleanLogits
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import build_csr_plan

    su = setup
    cfg = AttackConfig(eps=32.0, a=2.0, batch_size=4)
    ids = np.asarray(ids)
    args = [torch.from_numpy(np.asarray(a)) for a in (
        su["wts"][ids], su["idxs"][ids], su["ori"][ids], su["labels"][ids],
        np.asarray(valid, np.float32))]
    plan = build_csr_plan(args[1], args[0], su["delta0"].size // 4,
                          pair_mask=args[2][..., 3:] > 0)
    calls = []

    def logits_fn(x):
        calls.append(x.shape[0])
        return su["t_logits"](x)

    d0 = torch.from_numpy(su["delta0"])
    memo = CleanLogits()
    memo.at(0)
    runs = []
    for clean_logits in (None, memo):
        step = make_nerfail_s_step(logits_fn, cfg, resize_to,
                                   clean_logits=clean_logits)
        calls.clear()
        d1, m1 = step(d0, d0, *args, plan)
        d2, m2 = step(d1, d0, *args, plan)
        runs.append((d1, m1, d2, m2, len(calls)))
    (*want, want_calls), (*got, got_calls) = runs
    assert (want_calls, got_calls) == (4, 3)
    for w, g in zip(want, got):
        if isinstance(w, dict):
            for key in ("loss", "attacked_correct", "clean_correct"):
                assert torch.equal(g[key], w[key]), key
        else:
            assert torch.equal(g, w)


def _stepped(monkeypatch, memo: bool) -> list:
    """Replace make_nerfail_s_step with one whose steps keep each δ they
    make, through a wrapper of the step's eight-argument signature; with
    the driver's clean-logit memo, or without it, so that every step
    classifies the clean views again."""
    from nerfail_tpu_torch.attacks import nerfail_s

    deltas = []

    def make_kept(*args, clean_logits=None, **kwargs):
        step = make_nerfail_s_step(*args, **kwargs,
                                   clean_logits=clean_logits if memo else None)

        def kept(delta, delta0, weights, idx, ori, labels, valid, plan):
            out = step(delta, delta0, weights, idx, ori, labels, valid, plan)
            deltas.append(out[0].clone())
            return out

        return kept

    monkeypatch.setattr(nerfail_s, "make_nerfail_s_step", make_kept)
    return deltas


@pytest.mark.parametrize("resumed", [False, True])
def test_attack_classifies_clean_views_once_a_call(setup, monkeypatch,
                                                   tmp_path, resumed):
    """nerfail_s_attack over 4 epochs of 2 batches classifies each batch's
    clean views on its first visit of a call only: epochs × batches +
    batches classifier calls. Every step's δ, the history and the result
    equal those of the same run with every clean view classified on every
    step. Resumed from a checkpoint after 2 epochs, the memo refills on
    the first epoch that runs."""
    su = setup
    cfg = AttackConfig(eps=32.0, a=2.0, batch_size=4)
    n_batches = -(-N_VIEWS // cfg.batch_size)
    ckpt = str(tmp_path / "state.npz")

    def run(memo: bool):
        deltas, calls = _stepped(monkeypatch, memo), []

        def logits_fn(x):
            calls.append(x.shape[0])
            return su["t_logits"](x)

        def stop_at_2(epoch, entry):
            if epoch == 2:
                raise _Interrupt()

        common = (su["delta0"], su["wts"], su["idxs"], su["ori"],
                  su["labels"], logits_fn, cfg)
        if resumed:
            with pytest.raises(_Interrupt):
                nerfail_s_attack(*common, resize_to=16, epochs=4,
                                 device="cpu", checkpoint_path=ckpt,
                                 log_fn=stop_at_2)
            calls.clear()
        res = nerfail_s_attack(*common, resize_to=16, epochs=4,
                               device="cpu",
                               checkpoint_path=ckpt if resumed else None)
        return res, deltas, len(calls)

    want, want_deltas, want_calls = run(memo=False)
    got, got_deltas, got_calls = run(memo=True)
    epochs_run = 2 if resumed else 4
    assert want_calls == 2 * epochs_run * n_batches
    assert got_calls == epochs_run * n_batches + n_batches
    assert len(got_deltas) == len(want_deltas)
    for g, w in zip(got_deltas, want_deltas):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(got.delta, want.delta)
    assert got.best_attack_acc == want.best_attack_acc
    strip = lambda h: [{k: v for k, v in e.items() if k != "time_s"}
                       for e in h]
    assert strip(got.history) == strip(want.history)


def test_two_epoch_attack_matches_jax(setup):
    from nerfail_tpu.attacks.nerfail_s import nerfail_s_attack as j_attack

    su = setup
    cfg = AttackConfig(eps=32.0, a=2.0, batch_size=4)
    common = (su["delta0"], su["wts"], su["idxs"], su["ori"], su["labels"])
    jr = j_attack(*common, su["j_logits"], cfg, resize_to=None, epochs=2,
                  planned=False)
    tr = nerfail_s_attack(*common, su["t_logits"], cfg, resize_to=None,
                          epochs=2, device="cpu")
    assert [h["clean_acc"] for h in tr.history] == \
        [h["clean_acc"] for h in jr.history]
    assert np.mean(tr.delta == np.asarray(jr.delta)) >= 0.99
    assert np.abs(tr.delta[..., :3]).max() <= cfg.eps


class _Interrupt(Exception):
    pass


def test_interrupted_run_resumes_exactly(setup, tmp_path):
    su = setup
    cfg = AttackConfig(eps=32.0, a=2.0, batch_size=4)
    common = (su["delta0"], su["wts"], su["idxs"], su["ori"], su["labels"],
              su["t_logits"], cfg)
    full = nerfail_s_attack(*common, resize_to=None, epochs=3, device="cpu")

    ckpt = str(tmp_path / "state.npz")

    def stop_at_2(epoch, entry):
        if epoch == 2:
            raise _Interrupt()

    with pytest.raises(_Interrupt):
        nerfail_s_attack(*common, resize_to=None, epochs=3, device="cpu",
                         checkpoint_path=ckpt, log_fn=stop_at_2)
    resumed = nerfail_s_attack(*common, resize_to=None, epochs=3,
                               device="cpu", checkpoint_path=ckpt)
    np.testing.assert_array_equal(resumed.delta, full.delta)
    assert resumed.best_attack_acc == full.best_attack_acc
    strip = lambda h: [{k: v for k, v in e.items() if k != "time_s"}
                       for e in h]
    assert strip(resumed.history) == strip(full.history)


def test_evaluate_attack_matches_jax(setup):
    from nerfail_tpu.eval.harness import evaluate_attack as j_eval
    from nerfail_tpu_torch.eval.harness import evaluate_attack

    su = setup
    rng = np.random.default_rng(3)
    attacked = np.clip(su["clean"] + rng.uniform(-30, 30, su["clean"].shape),
                       0, 255).astype(np.float32)
    others = rng.uniform(0, 255, (4, H, H, 3)).astype(np.float32)
    kw = dict(true_label=int(su["labels"][0]), other_images=others,
              other_labels=np.arange(4), batch_size=4)
    want = j_eval(lambda x: su["j_logits"](jnp.asarray(x)), attacked,
                  su["clean"], **kw)
    got = evaluate_attack(su["t_logits"], attacked, su["clean"],
                          device="cpu", **kw)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
        else:
            assert got[k] == want[k], k


@pytest.mark.slow
def test_nerfail_s_fools_jax_trained_classifier():
    """tests/test_asr.py's acceptance with the port's engine: a SimpleCNN
    trained in JAX on 8 box classes is carried into the port, and the
    torch NeRFail-S must reach ASR ≥ 0.9 on class 0."""
    import optax

    from nerfail_tpu.data.synthetic import analytic_coord_map, make_box_scene
    from nerfail_tpu.models.classifiers.simple_cnn import SimpleCNN as J
    from nerfail_tpu.train.classifier_trainer import train_classifier
    from nerfail_tpu_torch.attacks.forward import (
        splat_attack_forward, white_composite_255,
    )
    from nerfail_tpu_torch.eval.harness import evaluate_attack
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
    from nerfail_tpu_torch.pointset.weights import gauss_weights

    Hs, n_cls, n_tr, n_va = 64, 8, 12, 3

    def white255(images):
        rgb = images[..., :3] * 255.0
        return np.where(images[..., 3:] > 0, rgb, 255.0).astype(np.float32)

    scenes = [make_box_scene(n_train=n_tr, n_val=n_va, n_test=0, H=Hs, W=Hs,
                             seed=100 + c, variant=c) for c in range(n_cls)]
    tr_x = np.concatenate([white255(s.images[s.i_split[0]]) for s in scenes])
    va_x = np.concatenate([white255(s.images[s.i_split[1]]) for s in scenes])
    hist = []
    state = train_classifier(
        J(num_classes=n_cls), tr_x, np.repeat(np.arange(n_cls), n_tr),
        va_x, np.repeat(np.arange(n_cls), n_va), epochs=40, batch_size=16,
        optimizer=optax.adam(1e-3), log_fn=lambda e, m: hist.append(m),
    )
    assert hist[-1]["val_acc"] >= 0.9
    model = load_flax_variables(
        SimpleCNN(num_classes=n_cls),
        jax.device_get({"params": state.params, **state.extra}))
    logits_fn = make_classifier_logits_fn(model)

    target = scenes[0]
    mask_views = [0, 2, 4, 6, 8, 10]
    S = np.concatenate([analytic_coord_map(target.poses[v], Hs, Hs, target.K)
                        .reshape(-1, 3) for v in mask_views])
    wts, idxs = [], []
    for v in range(n_tr):
        cm = analytic_coord_map(target.poses[v], Hs, Hs, target.K)
        d, i = build_index_and_dist(cm, S, device="cpu")
        wts.append(gauss_weights(d, c=0.02 * 800.0 / Hs).numpy())
        idxs.append(i.numpy())
    wts, idxs = np.stack(wts), np.stack(idxs)
    views = target.images[:n_tr]
    ori = np.concatenate([views[..., :3] * 255.0, views[..., 3:] * 255.0],
                         -1).astype(np.float32)
    delta0 = ori[mask_views].copy()
    delta0[..., :3] = 0.0
    cfg = AttackConfig(eps=64.0, a=4.0, batch_size=6, attack_epochs=60)
    res = nerfail_s_attack(delta0, wts, idxs, ori, np.zeros(n_tr), logits_fn,
                           cfg, resize_to=None, device="cpu")
    with torch.no_grad():
        out = splat_attack_forward(res.delta.reshape(-1, 4), wts, idxs, ori,
                                   logits_fn, eps=cfg.eps, resize_to=None,
                                   device="cpu")
        attacked = white_composite_255(out["attacked_rgba"][..., :3],
                                       out["attacked_rgba"][..., 3:]).numpy()
    report = evaluate_attack(logits_fn, attacked, white255(views),
                             true_label=0, num_classes=n_cls, device="cpu")
    assert report["clean_acc_target_class"] >= 0.9
    assert report["asr"] >= 0.9, f"ASR too low: {report}"
    assert report["e_max"] <= cfg.eps + 1e-3, report["e_max"]
