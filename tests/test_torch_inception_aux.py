"""PyTorch port: Inception-V3's auxiliary head against the JAX module.

The JAX model is initialised in train mode (as `init_classifier` and
every JAX checkpoint have it), its variables are carried into the port,
and one train-mode forward on the same batch must give the same `aux`
logits and leave the same BatchNorm running statistics as flax's
`apply(..., train=True, mutable=["batch_stats"])`. The head needs the
17×17 map of a 299² input. Tolerances: aux 2e-3 (94 fp32 convolutions
summed in other orders, then train-mode BatchNorm over the aux head's
batch of 2 at 1×1, which rescales those differences); the statistics
5e-4 of each leaf's largest magnitude, as the logits; eval-mode logits
5e-4, as tests/test_torch_classifiers.py holds Inception.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.models.classifiers.convert import (  # noqa: E402
    flax_to_state_dict, load_flax_variables,
)
from nerfail_tpu_torch.models.classifiers.inception_v3 import (  # noqa: E402
    InceptionV3,
)

SIZE = 299


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_run():
    """Train-mode variables, a batch, and JAX's train-mode aux, updated
    statistics and eval-mode logits on it."""
    from nerfail_tpu.models.classifiers.inception_v3 import InceptionV3 as J

    jm = J(num_classes=8)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    variables = jax.device_get(jax.jit(lambda k: jm.init(
        {"params": k, "dropout": k}, jnp.zeros((1, SIZE, SIZE, 3)),
        train=True))(key))
    (_, aux), new = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"],
        rngs={"dropout": key}))(variables, jnp.asarray(x))
    logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return {"variables": variables, "x": x, "aux": np.asarray(aux),
            "stats": jax.device_get(new["batch_stats"]),
            "logits": np.asarray(logits)}


def test_train_mode_aux_and_batch_stats_match_jax(jax_run):
    model = load_flax_variables(InceptionV3(num_classes=8),
                                jax_run["variables"]).train()
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(jax_run["x"]))
    assert logits.shape == aux.shape == (2, 8)
    np.testing.assert_allclose(aux.numpy(), jax_run["aux"], rtol=2e-3,
                               atol=2e-3)
    sd = model.state_dict()
    n = 0
    for path, want in jax.tree_util.tree_leaves_with_path(jax_run["stats"]):
        names = [p.key for p in path]
        buf = {"mean": "running_mean", "var": "running_var"}[names[-1]]
        got = sd[".".join(names[:-1] + [buf])].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-4 * np.abs(want).max(),
                                   err_msg="/".join(names))
        n += 1
    # every ConvBN of the trunk and the head moved its statistics
    assert n == 2 * sum(1 for m in model.modules()
                        if isinstance(m, torch.nn.BatchNorm2d))


def test_eval_mode_logits_unchanged_by_the_head(jax_run):
    """Eval mode returns the logits alone and does not run the head: the
    same as JAX's eval apply, and as a model built without the head."""
    x = torch.from_numpy(jax_run["x"])
    with_head = load_flax_variables(InceptionV3(num_classes=8),
                                    jax_run["variables"]).eval()
    variables = {c: {k: v for k, v in tree.items() if k != "InceptionAux_0"}
                 for c, tree in jax_run["variables"].items()}
    without = load_flax_variables(
        InceptionV3(num_classes=8, aux_logits=False), variables).eval()
    calls = []
    with_head.InceptionAux_0.register_forward_hook(
        lambda *a: calls.append(1))
    with torch.no_grad():
        got = with_head(x)
        bare = without(x)
    assert isinstance(got, torch.Tensor) and not calls
    assert not hasattr(without, "InceptionAux_0")
    assert torch.equal(got, bare)
    np.testing.assert_allclose(got.numpy(), jax_run["logits"], rtol=5e-4,
                               atol=5e-4)


def test_train_and_eval_trees_load_as_flax_makes_them():
    from nerfail_tpu.models.classifiers.inception_v3 import InceptionV3 as J

    jm = J(num_classes=8)
    shapes = {t: jax.eval_shape(lambda t=t: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, SIZE, SIZE, 3)), train=t)) for t in (True, False)}
    train_tree, eval_tree = (jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes[t])
        for t in (True, False))
    assert "InceptionAux_0" in train_tree["params"]
    assert "InceptionAux_0" not in eval_tree["params"]

    # the train tree (init_classifier, every JAX checkpoint) fills the head
    head = InceptionV3(num_classes=8)
    sd = flax_to_state_dict(head, train_tree)
    assert set(sd) == set(head.state_dict())
    assert all(float(sd[k].abs().max()) == 0 for k in sd
               if k.startswith("InceptionAux_0."))
    # the eval tree loads into a model without the head ...
    bare = InceptionV3(num_classes=8, aux_logits=False)
    assert set(flax_to_state_dict(bare, eval_tree)) == set(bare.state_dict())
    # ... and into one with it, whose head keeps its own values
    sd = flax_to_state_dict(head, eval_tree)
    k = "InceptionAux_0.Dense_0.weight"
    assert torch.equal(sd[k], head.state_dict()[k])
    # a head's leaves with no head raise, and so does a head in part
    with pytest.raises(ValueError, match="no counterpart"):
        flax_to_state_dict(bare, train_tree)
    part = {c: dict(t) for c, t in train_tree.items()}
    part["params"]["InceptionAux_0"] = {
        k: v for k, v in train_tree["params"]["InceptionAux_0"].items()
        if k != "Dense_0"}
    with pytest.raises(ValueError, match="has no flax leaf"):
        flax_to_state_dict(head, part)
