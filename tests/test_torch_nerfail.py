"""PyTorch port, slice 2 as a whole: the NeRFail (DeepFool) attack vs JAX.

Both packages get the same numpy tables and a linear classifier on 8×8
views. The port runs its default engine path (K1/K2's plain versions on
the CPU); the JAX package runs its generic-jacobian path, whose semantics
are the same. The control plane must agree exactly: per-epoch m1, m2,
attack_acc, deepfool_calls and mean iterations. δ agrees at atol 1e-3
(fp32 sums in other orders, accumulated over every DeepFool step).

The fixtures: "toy" is tests/test_attacks.py:255-278 (no view ever
flips; the m1 bisection ping-pongs until the epoch cap); "flip" flips
every view in epoch 0; "control" runs the m2 ×10 escalation, the m1
bisection down and up, and the cap.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.attacks.nerfail import nerfail_attack  # noqa: E402
from nerfail_tpu_torch.config import AttackConfig  # noqa: E402

H = W = 8
P = 2
C = 4
M = P * H * W

FIXTURES = {
    # n views, classifier scale, random clean images, epochs, config
    "toy": (3, 1e-3, False, 3, dict(eps=32.0, m1=0.0, m2=0.2,
                                    df_max_iter=10, view_batch=2)),
    "flip": (3, 1e-2, True, 3, dict(eps=32.0, m1=0.0, m2=100.0,
                                    df_max_iter=10, view_batch=2)),
    "control": (12, 3e-3, True, 4, dict(eps=32.0, m1=4.0, m2=30.0,
                                        df_max_iter=6, view_batch=4)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fixture(name):
    n, scale, textured, epochs, kw = FIXTURES[name]
    rng = np.random.default_rng(0)
    weights = rng.uniform(0, 1, (n, H, W, 8)).astype(np.float32)
    weights /= weights.sum(-1, keepdims=True)
    idx = rng.integers(0, M, (n, H, W, 8)).astype(np.int32)
    if textured:
        ori = rng.uniform(60, 200, (n, H, W, 4)).astype(np.float32)
        ori[..., 3] = 255.0
        ori[:, 0, :3, 3] = 0.0                 # a few background pixels
    else:
        ori = np.full((n, H, W, 4), 128.0, np.float32)
        ori[..., 3] = 255.0
    Wc = rng.standard_normal((H * W * 3, C)).astype(np.float32) * scale
    delta0 = np.zeros((P, H, W, 4), np.float32)
    delta0[..., 3] = 255.0
    tW = torch.from_numpy(Wc)
    return dict(
        weights=weights, idx=idx, ori=ori, delta0=delta0, epochs=epochs,
        cfg=AttackConfig(**kw),
        j_logits=lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(Wc),
        t_logits=lambda x: x.reshape(x.shape[0], -1) @ tW,
    )


def _strip(history):
    return [{k: v for k, v in h.items()
             if k not in ("time_s", "deepfool_iters")} for h in history]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_nerfail_attack_matches_jax(name):
    from nerfail_tpu.attacks.nerfail import nerfail_attack as j_attack

    f = _fixture(name)
    common = (f["delta0"], f["weights"], f["idx"], f["ori"])
    jr = j_attack(*common, f["j_logits"], f["cfg"], resize_to=None,
                  epochs=f["epochs"], planned=False)
    tr = nerfail_attack(*common, f["t_logits"], f["cfg"], resize_to=None,
                        epochs=f["epochs"], device="cpu")
    want = _strip(jr.history)
    got = _strip(tr.history)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "mean_df_iters":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-12)
            else:
                assert g[k] == w[k], (k, g, w)
    assert tr.best_attack_acc == jr.best_attack_acc
    np.testing.assert_allclose(tr.delta, np.asarray(jr.delta), atol=1e-3)
    np.testing.assert_array_equal(tr.delta[..., 3], 255.0)
    if name == "flip":
        assert np.abs(tr.delta[..., :3]).max() > 1.0


def test_engine_and_generic_paths_agree():
    """planned=False (the generic per-class jacobian through the batched
    splat) is the port's second oracle for its engine path."""
    f = _fixture("control")
    common = (f["delta0"], f["weights"], f["idx"], f["ori"], f["t_logits"],
              f["cfg"])
    a = nerfail_attack(*common, resize_to=None, epochs=f["epochs"],
                       device="cpu")
    b = nerfail_attack(*common, resize_to=None, epochs=f["epochs"],
                       device="cpu", planned=False)
    assert [h["deepfool_iters"] for h in a.history] == \
        [h["deepfool_iters"] for h in b.history]
    assert _strip(a.history) == _strip(b.history)
    np.testing.assert_allclose(a.delta, b.delta, atol=1e-3)


class _Interrupt(Exception):
    pass


def test_interrupted_run_resumes_exactly(tmp_path):
    f = _fixture("control")
    common = (f["delta0"], f["weights"], f["idx"], f["ori"], f["t_logits"],
              f["cfg"])
    full = nerfail_attack(*common, resize_to=None, epochs=f["epochs"],
                          device="cpu")
    ckpt = str(tmp_path / "state.npz")
    seen = []

    def stop_after_3(epoch, entry):
        seen.append(epoch)
        if len(seen) == 4:          # the 4th executed epoch raises
            raise _Interrupt()

    with pytest.raises(_Interrupt):
        nerfail_attack(*common, resize_to=None, epochs=f["epochs"],
                       device="cpu", checkpoint_path=ckpt,
                       log_fn=stop_after_3)
    resumed = nerfail_attack(*common, resize_to=None, epochs=f["epochs"],
                             device="cpu", checkpoint_path=ckpt)
    np.testing.assert_array_equal(resumed.delta, full.delta)
    assert resumed.best_attack_acc == full.best_attack_acc
    strip = lambda h: [{k: v for k, v in e.items() if k != "time_s"}
                       for e in h]
    assert strip(resumed.history) == strip(full.history)


def _nerfail_acceptance(logits_fn, device="cpu"):
    """tests/test_asr.py:157-176 with the port's NeRFail on the CPU."""
    from nerfail_tpu_torch.eval import asr_fixture as fx

    scenes, _ = fx.box_classes()
    tables = fx.attack_tables(scenes[0], device)
    cfg = fx.NERFAIL_CFG
    res = nerfail_attack(tables["delta0"], tables["wts"], tables["idxs"],
                         tables["ori"], logits_fn, cfg, resize_to=None,
                         device=device)
    # the engine's own bookkeeping must agree the attack landed
    assert res.best_attack_acc <= 0.1, res.history
    report = fx.acceptance(logits_fn, tables, res.delta, cfg.eps, device)
    assert report["clean_acc_target_class"] >= 0.9
    assert report["asr"] >= 0.9, f"ASR too low: {report}"
    assert report["e_max"] <= cfg.eps + 1e-3, report["e_max"]


@pytest.mark.slow
def test_nerfail_fools_jax_trained_classifier():
    """A SimpleCNN trained in JAX on the 8 box classes, carried into the
    port by convert.py: the port's NeRFail reaches ASR ≥ 0.9."""
    import optax

    from nerfail_tpu.models.classifiers.simple_cnn import SimpleCNN as J
    from nerfail_tpu.train.classifier_trainer import train_classifier
    from nerfail_tpu_torch.attacks.forward import make_classifier_logits_fn
    from nerfail_tpu_torch.eval import asr_fixture as fx
    from nerfail_tpu_torch.models.classifiers.convert import (
        load_flax_variables,
    )
    from nerfail_tpu_torch.models.classifiers.simple_cnn import SimpleCNN

    _, data = fx.box_classes()
    hist = []
    state = train_classifier(
        J(num_classes=fx.N_CLASSES), data["tr_x"], data["tr_y"],
        data["va_x"], data["va_y"], epochs=40, batch_size=16,
        optimizer=optax.adam(1e-3), log_fn=lambda e, m: hist.append(m),
    )
    assert hist[-1]["val_acc"] >= 0.9
    model = load_flax_variables(
        SimpleCNN(num_classes=fx.N_CLASSES),
        jax.device_get({"params": state.params, **state.extra}))
    _nerfail_acceptance(make_classifier_logits_fn(model))


@pytest.mark.slow
def test_nerfail_fools_port_trained_classifier():
    """The same acceptance with a SimpleCNN trained by the port's own
    trainer (Adam 1e-3, 40 epochs, batch 16)."""
    from nerfail_tpu_torch.attacks.forward import make_classifier_logits_fn
    from nerfail_tpu_torch.eval import asr_fixture as fx

    _, data = fx.box_classes()
    model, hist = fx.train_box_classifier(data, device="cpu")
    assert hist[-1]["val_acc"] >= 0.9, hist[-1]
    _nerfail_acceptance(make_classifier_logits_fn(model))
