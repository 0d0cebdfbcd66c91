"""PyTorch port: the classifier trainer and its checkpoints vs JAX.

Parameters start equal (flax init carried into the port by
models/classifiers/convert) and both packages take the same batches.
Tolerance rtol 1e-5 on the parameters after a few steps: the gradients
differ only by fp32 summation order, and a step moves a parameter by
about lr = 1e-3 of its size.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.models.classifiers.convert import (  # noqa: E402
    flax_to_state_dict, load_flax_variables,
)
from nerfail_tpu_torch.models.classifiers.simple_cnn import (  # noqa: E402
    SimpleCNN,
)
from nerfail_tpu_torch.train.checkpoint import (  # noqa: E402
    checkpoint_path, latest_checkpoint, load_checkpoint, save_checkpoint,
)
from nerfail_tpu_torch.train.classifier_trainer import (  # noqa: E402
    evaluate_accuracy, load_classifier, make_classifier_train_step,
    train_classifier,
)

S = 16
N_CLASSES = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (n, S, S, 3)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, n).astype(np.int64)
    return x, y


def _assert_params_close(model, jmodel_t, variables, loose=None):
    """Parameters at rtol 1e-5, except the entries where `loose` (name →
    bool mask) is True; returns JAX's parameters by port name."""
    want = flax_to_state_dict(jmodel_t, jax.device_get(variables))
    got = model.state_dict()
    for k, v in want.items():
        g, w = got[k].numpy(), v.numpy()
        m = np.zeros(g.shape, bool) if loose is None else loose[k]
        np.testing.assert_allclose(g[~m], w[~m], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    return {k: v.numpy() for k, v in want.items()}


def _optimizers(kind):
    import optax

    if kind == "sgd_momentum":
        return (optax.sgd(1e-3, momentum=0.9),
                lambda p: torch.optim.SGD(p, lr=1e-3, momentum=0.9))
    return optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3)


@pytest.mark.parametrize("kind", ["sgd_momentum", "adam"])
def test_train_step_matches_optax(kind):
    """One step of the port's train step, with SGD-momentum and with Adam,
    against the JAX step with optax on copied SimpleCNN parameters.

    Adam's first step moves a parameter by lr·g/(|g| + ε), ε = 1e-8: near
    |g| ≈ ε the two packages' last-bit gradient differences change the
    step by up to lr. Entries with 0 < |g| < 100·ε (about 1 % of the 1.2 M
    here; 3 of them differ beyond rtol 1e-5) are held instead to the step
    computed from the port's own gradient, at rtol 1e-5, and to the sign
    of JAX's step where |g| ≥ ε; the rest, exact zeros included, to JAX's
    parameters at rtol 1e-5."""
    from nerfail_tpu.models.classifiers.simple_cnn import SimpleCNN as J
    from nerfail_tpu.train.classifier_trainer import (
        init_classifier, make_classifier_train_step as j_make_step,
    )

    j_opt, t_opt = _optimizers(kind)
    jmodel = J(num_classes=N_CLASSES)
    state = init_classifier(jmodel, jax.random.PRNGKey(3), S, j_opt)
    model = load_flax_variables(SimpleCNN(num_classes=N_CLASSES),
                                jax.device_get({"params": state.params}))
    x, y = _data(10, 8)
    p0 = {k: v.clone() for k, v in model.state_dict().items()}
    params, _, _, jm = j_make_step(jmodel, j_opt)(
        state.params, state.extra, state.opt_state, jnp.asarray(x),
        jnp.asarray(y), jax.random.PRNGKey(0))
    tm = make_classifier_train_step(model, t_opt(model.parameters()))(
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])
    loose = None
    if kind == "adam":
        loose = {k: ((p.grad.abs() < 1e-6) & (p.grad != 0)).numpy()
                 for k, p in model.named_parameters()}
        n_loose = sum(int(m.sum()) for m in loose.values())
        assert n_loose < 0.02 * sum(p.numel() for p in model.parameters())
    want = _assert_params_close(model, SimpleCNN(num_classes=N_CLASSES),
                                {"params": params}, loose)
    if kind == "adam":
        n_firm = 0
        for k, p in model.named_parameters():
            m = loose[k]
            g = p.grad.detach().numpy()[m].astype(np.float64)
            start = p0[k].numpy()[m]
            step = -1e-3 * g / (np.abs(g) + 1e-8)
            np.testing.assert_allclose(p.detach().numpy()[m], start + step,
                                       rtol=1e-5, atol=1e-9, err_msg=k)
            firm = np.abs(g) >= 1e-8
            n_firm += int(firm.sum())
            assert (np.sign(want[k][m] - start)[firm]
                    == np.sign(step)[firm]).all(), k
        assert n_firm > 0


class _JStub:
    """A flax stub whose train mode returns (logits, aux), like
    Inception-V3 with its auxiliary head."""

    @staticmethod
    def make():
        import flax.linen as fnn

        class Stub(fnn.Module):
            @fnn.compact
            def __call__(self, x, train: bool = False):
                h = x.reshape(x.shape[0], -1) / 255.0
                logits = fnn.Dense(N_CLASSES)(h)
                aux = fnn.Dense(N_CLASSES)(h)
                return (logits, aux) if train else logits

        return Stub()


class _TStub(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(S * S * 3, N_CLASSES)
        self.Dense_1 = nn.Linear(S * S * 3, N_CLASSES)

    def forward(self, x):
        h = x.reshape(x.shape[0], -1) / 255.0
        logits = self.Dense_0(h)
        return (logits, self.Dense_1(h)) if self.training else logits


def test_aux_outputs_get_their_weight():
    """(logits, aux) outputs: loss = CE(logits) + 0.4·CE(aux), against the
    JAX step on the same stub; eval-mode accuracy reads the logits."""
    import optax

    from nerfail_tpu.train.classifier_trainer import (
        init_classifier, make_classifier_train_step as j_make_step,
    )

    jmodel = _JStub.make()
    state = init_classifier(jmodel, jax.random.PRNGKey(4), S,
                            optax.sgd(1e-2))
    model = load_flax_variables(_TStub(),
                                jax.device_get({"params": state.params}))
    x, y = _data(20, 8)
    _, _, _, jm = j_make_step(jmodel, optax.sgd(1e-2))(
        state.params, state.extra, state.opt_state, jnp.asarray(x),
        jnp.asarray(y), jax.random.PRNGKey(0))
    tm = make_classifier_train_step(
        model, torch.optim.SGD(model.parameters(), lr=1e-2))(
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    acc = evaluate_accuracy(model, x, y, batch_size=3, device="cpu")
    with torch.no_grad():
        want = float(np.mean(model.eval()(torch.from_numpy(x)).argmax(-1)
                             .numpy() == y))
    assert acc == want


def test_train_classifier_matches_jax():
    """Two epochs of train_classifier (reference SGD-momentum, the epoch
    permutation from np.random.default_rng(seed)) against the JAX trainer
    from the same initial parameters: same logs, same parameters."""
    import optax

    from nerfail_tpu.models.classifiers.simple_cnn import SimpleCNN as J
    from nerfail_tpu.train.classifier_trainer import (
        init_classifier, train_classifier as j_train,
    )

    x, y = _data(30, 24)
    vx, vy = _data(31, 8)
    jlog, tlog = [], []
    jstate = j_train(J(num_classes=N_CLASSES), x, y, vx, vy, epochs=2,
                     batch_size=8, seed=5,
                     log_fn=lambda e, m: jlog.append(m))
    init = init_classifier(J(num_classes=N_CLASSES), jax.random.PRNGKey(5),
                           S, optax.sgd(1e-3, momentum=0.9))
    model = load_flax_variables(SimpleCNN(num_classes=N_CLASSES),
                                jax.device_get({"params": init.params}))
    tstate = train_classifier(model, x, y, vx, vy, epochs=2, batch_size=8,
                              seed=5, log_fn=lambda e, m: tlog.append(m),
                              device="cpu")
    assert tstate.step == jstate.step == 6
    for t, j in zip(tlog, jlog):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
        assert t["acc"] == pytest.approx(j["acc"])
        assert t["val_acc"] == j["val_acc"]
    _assert_params_close(model, SimpleCNN(num_classes=N_CLASSES),
                         {"params": jstate.params})


def test_checkpoints_round_trip(tmp_path):
    """Atomic save/load of nested state, step-numbered discovery, and
    train_classifier's best / every-50-epochs files restored by
    load_classifier."""
    state = {"model": {"w": torch.arange(6.0).view(2, 3)}, "step": 7,
             "hist": [1.5, 2.5]}
    for step in (20, 100, 3):
        save_checkpoint(checkpoint_path(str(tmp_path), step), state)
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "000100.ckpt")
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    back = load_checkpoint(str(tmp_path / "000003.ckpt"))
    assert back["step"] == 7 and back["hist"] == [1.5, 2.5]
    torch.testing.assert_close(back["model"]["w"], state["model"]["w"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    logdir = str(tmp_path / "run")
    x, y = _data(40, 4)
    torch.manual_seed(0)
    model = _TStub()
    train_classifier(model, x, y, x, y, epochs=50, batch_size=4,
                     logdir=logdir, device="cpu",
                     optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))
    assert sorted(os.listdir(logdir)) == ["best.ckpt", "epoch_0050.ckpt"]
    last = load_classifier(os.path.join(logdir, "epoch_0050.ckpt"),
                           _TStub(), device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(last.state_dict()[k], v, rtol=0, atol=0)
    best = load_classifier(os.path.join(logdir, "best.ckpt"), _TStub(),
                           device="cpu")
    assert evaluate_accuracy(best, x, y, device="cpu") >= 0.0
