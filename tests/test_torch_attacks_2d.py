"""PyTorch port, slice 10: the 2D baselines (UAP-2D, IGSM-2D) and the
2D / split forwards against the JAX package.

Both packages get the same numpy inputs: a 32² box scene and a SimpleCNN
whose flax weights are carried into the port. Tolerances:
  - `universal_2d_forward`, `gauss_get_r`, `gauss_get_img`: logits
    within 1e-4 of the largest |logit|, images and r within 1e-3 on the
    0-255 scale;
  - IGSM-2D takes sign(∂loss/∂δ), so fp differences can flip entries
    whose gradient is near zero (ROADMAP Queue 3, "Sign ties"): each
    difference is a multiple of a, one step differs on < 0.5 % of
    entries and two epochs on < 2 %; the clean-accuracy history is equal;
  - UAP-2D's DeepFool argmin can fall either way on near-ties, so it is
    compared by its control-plane history (per-epoch attack accuracy)
    and its δ stays in the ε-ball;
  - both engines resume from a checkpoint exactly as an unbroken run.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.attacks.forward import (  # noqa: E402
    gauss_get_img, gauss_get_r, make_classifier_logits_fn,
    universal_2d_forward,
)
from nerfail_tpu_torch.attacks.igsm2d import (  # noqa: E402
    igsm_2d_attack, make_igsm2d_step,
)
from nerfail_tpu_torch.attacks.uap2d import (  # noqa: E402
    project_perturbation, uap_2d_attack,
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
    from nerfail_tpu.data.synthetic import make_box_scene
    from nerfail_tpu.models.classifiers.simple_cnn import SimpleCNN as J

    sc = make_box_scene(n_train=N_VIEWS, n_val=0, n_test=0, H=H, W=H,
                        seed=7)
    ori = (sc.images * 255.0).astype(np.float32)
    jmodel = J(num_classes=8)
    variables = jax.device_get(jmodel.init(
        jax.random.PRNGKey(2), jnp.zeros((1, H, H, 3)), train=False))
    tmodel = load_flax_variables(SimpleCNN(num_classes=8), variables)
    clean = np.where(ori[..., 3:] > 0, ori[..., :3], 255.0)
    preds = np.argmax(np.asarray(jmodel.apply(variables, jnp.asarray(clean))),
                      -1)
    # labels: the clean predictions on half the views, another class on
    # the rest, so both accuracies are non-trivial
    labels = np.where(np.arange(N_VIEWS) % 2 == 0, preds, (preds + 1) % 8)
    j_logits = j_logits_fn(jmodel, variables["params"], {})
    t_logits = make_classifier_logits_fn(tmodel)
    # the freshly initialised net's logits are ~1e-2 and its input
    # gradients tiny against DeepFool's 1e-4 regulariser; UAP-2D runs on
    # the logits ×1000 (the same map in both packages) so that its walks
    # finish and flip views within a few epochs
    return dict(ori=ori, labels=labels.astype(np.int64),
                j_logits=j_logits, t_logits=t_logits,
                j_logits_k=lambda x: 1000.0 * j_logits(x),
                t_logits_k=lambda x: 1000.0 * t_logits(x))


def _uap_cfg(view_batch):
    return AttackConfig(method="Universal_2D", eps=64.0, m1=1.0, m2=2.0,
                        df_max_iter=30, overshoot=0.2, view_batch=view_batch)


def _logit_tol(x):
    return 1e-4 * max(float(np.abs(x).max()), 1.0)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("resize_to", [None, 24])
def test_universal_2d_forward_matches_jax(setup, batched, resize_to):
    from nerfail_tpu.attacks.forward import universal_2d_forward as J

    rng = np.random.default_rng(1)
    shape = (N_VIEWS, H, H, 3) if batched else (H, H, 3)
    delta = rng.uniform(-40, 40, shape).astype(np.float32)
    j = J(jnp.asarray(delta), jnp.asarray(setup["ori"]), setup["j_logits"],
          resize_to)
    with torch.no_grad():
        t = universal_2d_forward(delta, setup["ori"], setup["t_logits"],
                                 resize_to, device="cpu")
    np.testing.assert_allclose(t["attacked_rgb"].numpy(),
                               np.asarray(j["attacked_rgb"]), atol=1e-3,
                               rtol=0)
    for k in ("logits", "ori_logits"):
        jk = np.asarray(j[k])
        np.testing.assert_allclose(t[k].numpy(), jk, atol=_logit_tol(jk),
                                   rtol=0)


def test_gauss_get_r_and_img_match_jax(setup):
    from nerfail_tpu.attacks.forward import gauss_get_img as Ji
    from nerfail_tpu.attacks.forward import gauss_get_r as Jr

    rng = np.random.default_rng(2)
    M = 2 * H * H
    pts = np.concatenate([rng.uniform(-60, 60, (M, 3)),
                          rng.uniform(0, 255, (M, 1))], -1).astype(np.float32)
    dist = rng.uniform(0, 0.05, (N_VIEWS, H, H, 8)).astype(np.float32)
    idx = rng.integers(0, M, (N_VIEWS, H, H, 8)).astype(np.int32)
    jr = np.asarray(Jr(jnp.asarray(pts), jnp.asarray(dist),
                       jnp.asarray(idx), c=0.5))
    tr = gauss_get_r(pts, dist, idx, c=0.5, device="cpu").numpy()
    np.testing.assert_allclose(tr, jr, atol=1e-3, rtol=0)
    for eps in (None, 8.0):
        j = Ji(jnp.asarray(jr), jnp.asarray(setup["ori"]),
               setup["j_logits"], eps=eps, resize_to=24)
        with torch.no_grad():
            t = gauss_get_img(jr, setup["ori"], setup["t_logits"], eps=eps,
                              resize_to=24, device="cpu")
        np.testing.assert_allclose(t["attacked_rgba"].numpy(),
                                   np.asarray(j["attacked_rgba"]), atol=1e-3,
                                   rtol=0)
        for k in ("logits", "ori_logits"):
            jk = np.asarray(j[k])
            np.testing.assert_allclose(t[k].numpy(), jk,
                                       atol=_logit_tol(jk), rtol=0)


@pytest.mark.parametrize("p", [2, np.inf])
def test_project_perturbation_matches_jax(p):
    from nerfail_tpu.attacks.uap2d import project_perturbation as J

    d = np.random.default_rng(0).uniform(-50, 50, (H, H, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        project_perturbation(10.0, p, torch.from_numpy(d)).numpy(),
        np.asarray(J(10.0, p, jnp.asarray(d))), rtol=1e-6, atol=1e-5)


def _assert_sign_agreement(t, j, a, max_flip):
    steps = (t - j) / a
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-4)
    assert np.mean(t != j) < max_flip


@pytest.mark.parametrize("beta,targeted", [(0.0, False), (0.3, True)])
def test_igsm2d_step_matches_jax(setup, beta, targeted):
    from nerfail_tpu.attacks.igsm2d import make_igsm2d_step as J

    cfg = AttackConfig(method="IGSM_2D", eps=32.0, a=2.0, beta=beta,
                       targeted=targeted)
    rng = np.random.default_rng(4)
    d = (2.0 * rng.integers(-3, 4, (4, H, H, 3))).astype(np.float32)
    ori, labels = setup["ori"][:4], setup["labels"][:4]
    jd, jm = J(setup["j_logits"], cfg, 24)(
        jnp.asarray(d), jnp.asarray(ori), jnp.asarray(labels))
    td, tm = make_igsm2d_step(setup["t_logits"], cfg, 24)(
        torch.from_numpy(d), torch.from_numpy(ori), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    for k in ("attacked_correct", "clean_correct"):
        assert int(tm[k]) == int(jm[k])
    _assert_sign_agreement(td.numpy(), np.asarray(jd), cfg.a, 0.005)
    assert np.abs(td.numpy()).max() <= cfg.eps


def test_igsm2d_attack_matches_jax(setup):
    from nerfail_tpu.attacks.igsm2d import igsm_2d_attack as J

    cfg = AttackConfig(method="IGSM_2D", eps=8.0, a=2.0, batch_size=4)
    args = (setup["ori"], setup["labels"])
    jr = J(*args, setup["j_logits"], cfg, resize_to=None, epochs=2)
    tr = igsm_2d_attack(*args, setup["t_logits"], cfg, resize_to=None,
                        epochs=2, device="cpu")
    assert [h["clean_acc"] for h in tr.history] == \
        [h["clean_acc"] for h in jr.history]
    assert tr.delta.shape == (N_VIEWS, H, H, 3)
    _assert_sign_agreement(tr.delta, np.asarray(jr.delta), cfg.a, 0.02)
    assert np.abs(tr.delta).max() <= cfg.eps


@pytest.mark.parametrize("view_batch", [1, 4])
def test_uap2d_attack_matches_jax_history(setup, view_batch):
    from nerfail_tpu.attacks.uap2d import uap_2d_attack as J

    cfg = _uap_cfg(view_batch)
    jr = J(setup["ori"], setup["j_logits_k"], cfg, resize_to=None, epochs=3)
    tr = uap_2d_attack(setup["ori"], setup["t_logits_k"], cfg,
                       resize_to=None, epochs=3, device="cpu")
    assert [h["attack_acc"] for h in tr.history] == \
        [h["attack_acc"] for h in jr.history]
    assert tr.best_attack_acc == jr.best_attack_acc
    assert tr.delta.shape == (H, H, 3)
    assert np.abs(tr.delta).max() <= cfg.eps
    assert tr.best_attack_acc < 1.0            # DeepFool flipped views


class _Interrupt(Exception):
    pass


def _strip(h):
    return [{k: v for k, v in e.items() if k != "time_s"} for e in h]


@pytest.mark.parametrize("engine", ["igsm2d", "uap2d"])
def test_interrupted_run_resumes_exactly(setup, tmp_path, engine):
    if engine == "igsm2d":
        cfg = AttackConfig(method="IGSM_2D", eps=8.0, a=2.0, batch_size=4)

        def run(**kw):
            return igsm_2d_attack(setup["ori"], setup["labels"],
                                  setup["t_logits"], cfg, resize_to=None,
                                  epochs=3, device="cpu",
                                  checkpoint_every=1, **kw)
    else:
        cfg = _uap_cfg(3)

        def run(**kw):
            return uap_2d_attack(setup["ori"], setup["t_logits_k"], cfg,
                                 resize_to=None, epochs=3, device="cpu",
                                 **kw)

    full = run()
    ckpt = tmp_path / "state.npz"

    def stop_at_2(epoch, entry):
        if epoch == 2:
            raise _Interrupt()

    with pytest.raises(_Interrupt):
        run(checkpoint_path=str(ckpt), log_fn=stop_at_2)
    assert ckpt.exists()
    resumed = run(checkpoint_path=str(ckpt))
    np.testing.assert_array_equal(resumed.delta, full.delta)
    assert resumed.best_attack_acc == full.best_attack_acc
    assert _strip(resumed.history) == _strip(full.history)
    # a finished run removes its in-flight state (and IGSM's best bank)
    assert not ckpt.exists()
    assert not (tmp_path / "state.npz.best.npz").exists()
