"""PyTorch port, slice 11: the port held to the reference's own torch
outputs (tests/golden/reference_goldens.npz, made by EXECUTING the
reference's vendored torch models and its splat/composite/classifier
chain; tools/make_goldens.py), through `models/classifiers/torch_import`.

As tests/test_classifier_parity.py does for the JAX package, the weights
are regenerated from the golden's (kind, shape) sequence with the same
`fill_tensor` stream: seed 7 for InceptionResNetV2, seed 11 for MyCNN with
its 800² input drawn last. Tolerances:
  * `torch_tensor_shapes` equals the golden `kinds_json` entry for entry;
  * logits at rtol 2e-3 and atol 2e-3 × the logits' largest magnitude
    (test_classifier_parity.py's: fp32 convolutions summed in other
    orders through ~250 layers);
  * the JAX route (the JAX importer, then models/classifiers/convert.py)
    and the direct route give bit-equal parameters (both copy the same
    float32 values, transposed twice on the JAX route);
  * `gauss/*` at tests/test_parity.py:135-180's tolerances: splat and
    composite rtol 1e-4 / atol 1e-3, logits rtol 1e-3 / atol 1e-3, the
    pixel gradient rtol 1e-3 / atol 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.models.classifiers.incresv2 import (  # noqa: E402
    InceptionResNetV2,
)
from nerfail_tpu_torch.models.classifiers.simple_cnn import MyCNN  # noqa: E402
from nerfail_tpu_torch.models.classifiers.torch_import import (  # noqa: E402
    import_torch_state, state_dict_tensors, torch_tensor_shapes,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_goldens.npz")


@pytest.fixture(scope="module")
def golden():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden file missing — run tools/make_goldens.py")
    return np.load(GOLDEN)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def fill_tensor(rng, kind, shape):
    """tests/test_classifier_parity.py::fill_tensor (tools/make_goldens.py)."""
    if kind in ("bn_var", "bn_scale"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if kind == "bn_mean":
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if kind.endswith("_kernel"):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


MODELS = {"incresv2": (InceptionResNetV2, 7), "mycnn": (MyCNN, 11)}


def _kinds(golden, name):
    return json.loads(bytes(golden[f"{name}/kinds_json"]).decode())


@pytest.mark.parametrize("name", list(MODELS))
def test_tensor_sequence_equals_the_reference(golden, name):
    ours = torch_tensor_shapes(MODELS[name][0](num_classes=8))
    ref = _kinds(golden, name)
    assert len(ours) == len(ref)
    for i, ((k1, s1), (k2, s2)) in enumerate(zip(ours, ref)):
        assert k1 == k2 and list(s1) == list(s2), (i, k1, s1, k2, s2)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_the_reference(golden, name):
    cls, seed = MODELS[name]
    rng = np.random.default_rng(seed)
    tensors = [fill_tensor(rng, k, tuple(s)) for k, s in _kinds(golden, name)]
    if name == "incresv2":
        x = golden["incresv2/input"]          # [1, 299, 299, 3] 0-255
    else:
        x = rng.uniform(0, 255, (1, 800, 800, 3)).astype(np.float32)
    model = import_torch_state(cls(num_classes=8).eval(), tensors)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = golden[f"{name}/logits"]
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=2e-3)


class _TorchConvBNDense(torch.nn.Module):
    """The port's side of `_flax_conv_bn_dense`, named as flax names it."""

    def __init__(self):
        super().__init__()
        from nerfail_tpu_torch.models.classifiers.common import BatchNorm

        self.Conv_0 = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(8, eps=1e-3)
        self.Conv_1 = torch.nn.Conv2d(8, 16, 3, padding=1)
        self.Dense_0 = torch.nn.Linear(16, 8)

    def forward(self, x):
        h = torch.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        return self.Dense_0(self.Conv_1(h).mean(dim=(2, 3)))


def _flax_conv_bn_dense():
    import flax.linen as nn

    class ConvBNDense(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            x = nn.Conv(8, (3, 3), use_bias=False)(x)
            x = nn.relu(nn.BatchNorm(use_running_average=not train,
                                     epsilon=1e-3)(x))
            x = nn.Conv(16, (3, 3))(x)
            return nn.Dense(8)(x.mean(axis=(1, 2)))

    return ConvBNDense()


@pytest.mark.parametrize("name", ["mycnn", "conv_bn_dense"])
def test_jax_route_and_direct_route_give_the_same_parameters(golden, name):
    """Reference tensors → the JAX importer → flax variables → convert.py,
    against reference tensors → torch_import: MyCNN with the golden's
    tensors (conv and dense units), and a conv + BatchNorm + dense net
    (InceptionResNetV2's units; a flax init of InceptionResNetV2 itself
    takes about a minute here)."""
    from nerfail_tpu.models.classifiers.simple_cnn import MyCNN as JMyCNN
    from nerfail_tpu.models.classifiers.torch_import import (
        import_torch_state as j_import,
    )
    from nerfail_tpu_torch.models.classifiers.convert import (
        load_flax_variables,
    )

    if name == "mycnn":
        jmodel, size, seed = JMyCNN(num_classes=8), 800, 11

        def make():
            return MyCNN(num_classes=8)
        kinds = _kinds(golden, "mycnn")
    else:
        jmodel, make, size, seed = (_flax_conv_bn_dense(), _TorchConvBNDense,
                                    8, 3)
        kinds = torch_tensor_shapes(_TorchConvBNDense(), size=size)
    rng = np.random.default_rng(seed)
    tensors = [fill_tensor(rng, k, tuple(s)) for k, s in kinds]
    # a fresh init keeps flax's call order, which the JAX importer zips by
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)), train=False)
    params, stats = j_import(variables["params"],
                             variables.get("batch_stats", {}), tensors)
    tree = {"params": params}
    if stats:
        tree["batch_stats"] = stats
    via_jax = load_flax_variables(make(), jax.device_get(tree))
    direct = import_torch_state(make(), tensors, size=size)
    a, b = via_jax.state_dict(), direct.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    back = state_dict_tensors(b)
    assert len(back) == len(tensors)
    for t, u in zip(back, tensors):
        np.testing.assert_array_equal(t, u)


def test_state_dict_tensors_drops_num_batches_tracked():
    m = MyCNN(num_classes=8)
    sd = m.state_dict()
    sd["Fake_0.num_batches_tracked"] = torch.tensor(3)
    out = state_dict_tensors(sd)
    assert len(out) == len(m.state_dict())
    assert all(isinstance(t, np.ndarray) for t in out)


def test_importer_rejects_count_and_shape_mismatches():
    """A topology divergence fails loudly, naming the parameter, and
    leaves the model as it was."""
    m = MyCNN(num_classes=8)
    seq = torch_tensor_shapes(m)
    assert [k for k, _ in seq[:2]] == ["conv_kernel", "conv_bias"]
    good = [np.zeros(s, np.float32) for _, s in seq]
    before = {k: v.clone() for k, v in m.state_dict().items()}
    bad = list(good)
    bad[2] = np.zeros((64, 32, 5, 5), np.float32)     # wrong kernel size
    with pytest.raises(ValueError, match=r"shape mismatch at Conv_1\.weight"):
        import_torch_state(m, bad)
    with pytest.raises(ValueError, match="count mismatch"):
        import_torch_state(m, good[:-1])
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    import_torch_state(m, good)
    assert all(float(v.abs().max()) == 0 for v in m.state_dict().values())


def test_call_order_not_init_order():
    """A block whose __init__ registers its children in another order
    than it calls them is zipped in call order, as flax (and the
    reference's torch module, registered in call order) orders them."""
    class Swapped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = torch.nn.Linear(4, 2)
            self.Conv_0 = torch.nn.Conv2d(3, 4, 3)

        def forward(self, x):
            h = self.Conv_0(x.permute(0, 3, 1, 2))
            return self.Dense_0(h.mean(dim=(2, 3)))

    seq = torch_tensor_shapes(Swapped(), size=8)
    assert seq == [("conv_kernel", (4, 3, 3, 3)), ("conv_bias", (4,)),
                   ("dense_kernel", (2, 4)), ("dense_bias", (2,))]


class TestSplatGradient:
    """The port's splat forward, composite, logits and pixel gradient with
    the golden's linear head, as tests/test_parity.py::TestSplatGradient
    holds the JAX package."""

    @staticmethod
    def _logits_fn(g):
        Wc = torch.from_numpy(g["gauss/Wc"])

        def logits_fn(x):     # x [B, H, W, 3] 0-255 → torch CHW flatten
            return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1) @ Wc

        return logits_fn

    @staticmethod
    def _forward(g, delta):
        from nerfail_tpu_torch.attacks.forward import splat_attack_forward

        return splat_attack_forward(
            delta.reshape(-1, 4), g["gauss/weights"], g["gauss/idx"],
            g["gauss/ori"], TestSplatGradient._logits_fn(g), eps=32.0,
            resize_to=None, device="cpu")

    def test_forward_allclose(self, golden):
        g = golden
        out = self._forward(g, torch.from_numpy(g["gauss/spatial"]))
        for key, want, tol in (
                ("splat", "gauss/splat", dict(rtol=1e-4, atol=1e-3)),
                ("attacked_rgba", "gauss/attacked_rgba",
                 dict(rtol=1e-4, atol=1e-3)),
                ("logits", "gauss/logits", dict(rtol=1e-3, atol=1e-3)),
                ("ori_logits", "gauss/ori_logits",
                 dict(rtol=1e-3, atol=1e-3))):
            np.testing.assert_allclose(out[key].detach().numpy(), g[want],
                                       err_msg=key, **tol)

    def test_pixel_gradient_allclose(self, golden):
        g = golden
        delta = torch.from_numpy(g["gauss/spatial"]).requires_grad_(True)
        out = self._forward(g, delta)
        (grad,) = torch.autograd.grad(out["logits"][0, 0], delta)
        np.testing.assert_allclose(grad.numpy(), g["gauss/grad"], rtol=1e-3,
                                   atol=1e-6)
