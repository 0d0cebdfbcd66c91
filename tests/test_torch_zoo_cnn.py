"""PyTorch port: the convolutional classifier zoo against the JAX modules.

For each family the JAX module's variable tree is laid out by
`jax.eval_shape(init)` and filled from a seeded numpy generator: kernels
N(0, 1/fan_in), biases and BatchNorm shifts N(0, 0.1), scales U(0.5,
1.5), running means N(0, 0.1) and variances U(0.5, 1.5), as
tests/test_torch_classifiers.py randomises the statistics, so that every
bias, scale and statistic is wired and none hides as a zero. The tree is
carried into the port's module by convert.load_flax_variables and the
logits of a seeded 0-255 batch must agree. Input sizes: MobileNet 160²
as its executed-torch twin test, AlexNet 128² and VGG 64² to keep the
CPU time down, MyCNN its pinned 800². Tolerances (per family below):
fp32 sums in other orders by XLA and PyTorch's CPU kernels, relative to
the largest logit. The deeper families are in test_torch_zoo_cnn_deep.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.models.classifiers.convert import (  # noqa: E402
    load_flax_variables,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def random_variables(jmodel, size, rng):
    """A variable tree of `jmodel` at size² with seeded random leaves."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            # HWIO, [in, out] and the attention output's [heads, hd, D]
            # sum over all but the last axis; query/key/value's [D, h, hd]
            # over the first
            qkv = str(path[-2].key) in ("query", "key", "value")
            fan_in = s.shape[0] if qkv else int(np.prod(s.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, s.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape)
        # bias, mean, cls, pos_embedding, rel_pos_bias
        return rng.normal(0, 0.1, s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


def assert_logits_match(jmodel, tmodel, size, seed, tol, batch=2):
    rng = np.random.default_rng(seed)
    variables = random_variables(jmodel, size, rng)
    x = rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    load_flax_variables(tmodel, variables).eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (batch, 8)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _families():
    from nerfail_tpu.models.classifiers import (
        simple_cnn as jc, small_nets as js, vgg as jv,
    )
    from nerfail_tpu_torch.models.classifiers import (
        simple_cnn as tc, small_nets as ts, vgg as tv,
    )

    # name → (JAX module, port module, size, tolerance); the deeper
    # families are in tests/test_torch_zoo_cnn_deep.py
    return {
        "my_model": (jc.MyCNN(), tc.MyCNN(), 800, 1e-5),
        "alexnet": (js.AlexNet(), ts.AlexNet(), 128, 1e-5),
        "vgg16": (jv.VGG16(), tv.VGG16(), 64, 1e-5),
        "mobilenet_v2": (js.MobileNetV2(), ts.MobileNetV2(), 160, 1e-4),
    }


@pytest.mark.parametrize("name", ["my_model", "alexnet", "vgg16",
                                  "mobilenet_v2"])
def test_cnn_logits_match_jax(name):
    jm, tm, size, tol = _families()[name]
    assert_logits_match(jm, tm, size, seed=len(name), tol=tol)


def test_adaptive_avg_pool_builds_each_axis_from_its_own_extent():
    """Non-square inputs, and outputs larger than the input (bins that
    overlap), against torch's own adaptive pool; the JAX version is
    right only for square inputs, where the parity tests hold it."""
    from nerfail_tpu_torch.models.classifiers.small_nets import (
        adaptive_avg_pool,
    )

    rng = np.random.default_rng(0)
    for shape, out in (((2, 3, 13, 29), 6), ((1, 4, 5, 3), 7),
                       ((2, 2, 8, 8), 7)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        torch.testing.assert_close(adaptive_avg_pool(x, out),
                                   F.adaptive_avg_pool2d(x, out),
                                   rtol=1e-6, atol=1e-6)


def test_batchnorm_running_statistics_follow_flax():
    """Train mode normalises by the biased variance and moves the running
    variance toward it, as flax does (torch's own moves it toward the
    unbiased one)."""
    import flax.linen as fnn

    from nerfail_tpu_torch.models.classifiers.common import BatchNorm

    rng = np.random.default_rng(1)
    x = rng.normal(1.0, 2.0, (3, 2, 2, 5)).astype(np.float32)   # NHWC
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, new = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(5).train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    for buf, leaf in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn, buf).numpy(),
            np.asarray(new["batch_stats"][leaf]), rtol=1e-5, atol=1e-6)
