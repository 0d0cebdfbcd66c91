"""PyTorch port: classifiers with weights carried across from flax.

Each JAX classifier is initialised in flax, its BN running statistics are
randomised (so eps and the statistics' wiring are exercised), the
variables are carried into the port's module by
models/classifiers/convert.py, and the logits must agree. Tolerances are
those of the repo's executed-torch parity tests: fp32 convolutions summed
in another order by XLA and by PyTorch's CPU kernels (SimpleCNN 2e-4,
Inception-V3's 94 convolutions 5e-4).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.models.classifiers.convert import (  # noqa: E402
    flax_to_state_dict, load_flax_variables,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _randomized(variables, rng):
    out = {"params": jax.device_get(variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, x: (
                rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
                if "var" in str(path[-1]) else
                (rng.standard_normal(x.shape) * 0.1).astype(np.float32)
            ),
            jax.device_get(variables["batch_stats"]),
        )
    return out


def _compare(jmodel, tmodel, size, seed, tol):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (2, size, size, 3)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, size, size, 3)), train=False)
    variables = _randomized(variables, rng)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    load_flax_variables(tmodel, variables).eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return variables


def test_simple_cnn_logits_match_jax_at_64():
    from nerfail_tpu.models.classifiers.simple_cnn import SimpleCNN as J
    from nerfail_tpu_torch.models.classifiers.simple_cnn import SimpleCNN

    _compare(J(num_classes=8), SimpleCNN(num_classes=8), 64, 3, 2e-4)


def test_inception_v3_logits_match_jax_at_75():
    from nerfail_tpu.models.classifiers.inception_v3 import InceptionV3 as J
    from nerfail_tpu_torch.models.classifiers.inception_v3 import InceptionV3

    _compare(J(num_classes=8), InceptionV3(num_classes=8), 75, 4, 5e-4)


def test_converter_rejects_unused_missing_and_misshapen_leaves():
    from nerfail_tpu.models.classifiers.simple_cnn import SimpleCNN as J
    from nerfail_tpu_torch.models.classifiers.simple_cnn import SimpleCNN

    variables = jax.device_get(J(num_classes=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False))
    model = SimpleCNN(num_classes=8)
    sd = flax_to_state_dict(model, variables)
    assert set(sd) == set(model.state_dict())

    extra = {"params": dict(variables["params"])}
    extra["params"]["Conv_7"] = variables["params"]["Conv_6"]
    with pytest.raises(ValueError, match="no counterpart"):
        flax_to_state_dict(model, extra)

    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "Dense_1"}}
    with pytest.raises(ValueError, match="has no flax leaf"):
        flax_to_state_dict(model, missing)

    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(SimpleCNN(num_classes=5), variables)
