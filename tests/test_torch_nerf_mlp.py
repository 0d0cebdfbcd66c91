"""PyTorch port, slice 3: the NeRF MLP, its weight carrier, and the plain
versions of K4/K5 against the JAX package's fused kernel.

The JAX kernel runs in Pallas interpret mode on the CPU, as
tests/test_pallas_mlp.py runs it. Both packages take the same parameters
(JAX init carried over by `nerf_params_from_jax`) and the same seeded
points. Tolerances:
  * f32 operands (MATMUL_DTYPE set to float32 in both packages): the
    output, every parameter gradient and d_pts at rtol 1e-4 of each
    tensor's largest entry; the same f32 products summed in another order;
  * bf16 operands, the working type: 1 % of each tensor's largest entry
    (2 % for d_pts). The two packages round the same f32 values, but an
    activation whose f32 value differs in its last bit can round to a
    bf16 one ulp (2⁻⁸) away;
  * the port's unfused path against JAX apply_nerf: rtol 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu.config import NeRFModelConfig as JCfg  # noqa: E402
from nerfail_tpu.models.nerf import init_nerf_params as j_init  # noqa: E402
from nerfail_tpu_torch.config import NeRFModelConfig  # noqa: E402
from nerfail_tpu_torch.models.nerf import (  # noqa: E402
    apply_nerf, load_weights_from_keras, nerf_param_count,
    nerf_params_from_jax,
)
from nerfail_tpu_torch.ops.encoding import positional_encoding  # noqa: E402

CFG = dict(netdepth=4, netwidth=64, skips=(1,))


@pytest.fixture(autouse=True)
def _interpret_and_threads(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _setup(seed=0, n=300, **kw):
    cfg = dict(CFG, **kw)
    jp = jax.device_get(j_init(jax.random.PRNGKey(seed), JCfg(**cfg)))
    rng = np.random.default_rng(seed + 1)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return cfg, jp, pts, vd


def _scaled_close(got, want, frac, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, f"{what}: {err} > {frac} · {scale}"


def test_weight_carrier_round_trip_and_apply_nerf():
    from nerfail_tpu.models.nerf import apply_nerf as j_apply
    from nerfail_tpu.models.nerf import nerf_param_count as j_count
    from nerfail_tpu.ops.encoding import positional_encoding as j_pe

    cfg, jp, pts, vd = _setup()
    tp = nerf_params_from_jax(jp, device="cpu")
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tp[k].requires_grad and tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].detach().numpy(), np.asarray(v))
    assert nerf_param_count(tp) == j_count(jp)
    t_cfg = NeRFModelConfig(**cfg)
    got = apply_nerf(tp, t_cfg, positional_encoding(torch.from_numpy(pts), 10),
                     positional_encoding(torch.from_numpy(vd), 4))
    want = j_apply(jp, JCfg(**cfg), j_pe(jnp.asarray(pts), 10),
                   j_pe(jnp.asarray(vd), 4))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_init_nerf_params_shapes_and_density_bias():
    from nerfail_tpu_torch.models.nerf import init_nerf_params

    cfg = NeRFModelConfig(**CFG)
    a = init_nerf_params(torch.Generator().manual_seed(0), cfg, "cpu")
    b = init_nerf_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jp = j_init(jax.random.PRNGKey(0), JCfg(**CFG))
    for k, v in jp.items():
        assert tuple(a[k].shape) == v.shape, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    bound = 1.0 / np.sqrt(cfg.netwidth)
    assert float(a["feature_w"].detach().abs().max()) <= bound
    assert 0.5 - bound <= float(a["alpha_b"].detach()) <= 0.5 + bound


def test_load_weights_from_keras_goldens():
    from nerfail_tpu.models.nerf import load_weights_from_keras as j_keras

    g = np.load("tests/golden/reference_goldens.npz")
    kw = dict(netdepth=2, netwidth=32, skips=(0,), multires=4,
              multires_views=2, density_init_bias=0.0)
    w = [g[f"render/weights_coarse/{i}"] for i in range(12)]
    tp = load_weights_from_keras(NeRFModelConfig(**kw), w, device="cpu")
    jp = j_keras(JCfg(**kw), w)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k]))


def _both(cfg, jp, pts, vd, f32: bool, monkeypatch):
    """(port raw, port grads, JAX raw, JAX grads) of sum(tanh(raw)) with
    respect to every parameter and the points."""
    import nerfail_tpu.ops.pallas.mlp_kernel as jmk
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk

    if f32:
        monkeypatch.setattr(jmk, "MATMUL_DTYPE", jnp.float32)
        monkeypatch.setattr(tmk, "MATMUL_DTYPE", torch.float32)
    j_cfg = JCfg(**cfg)
    vdj = jnp.asarray(vd)

    def loss(p, x):
        return jnp.sum(jnp.tanh(jmk.nerf_mlp_fused(p, j_cfg, x, vdj,
                                                   input_grads=True)))

    j_raw = jmk.nerf_mlp_fused(jp, j_cfg, jnp.asarray(pts), vdj)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(pts))
    tp = nerf_params_from_jax(jp, device="cpu")
    x = torch.from_numpy(pts).requires_grad_(True)
    raw = tmk.nerf_mlp_fused(tp, NeRFModelConfig(**cfg), x,
                             torch.from_numpy(vd))
    names = list(tp)
    grads = torch.autograd.grad(torch.tanh(raw).sum(),
                                [tp[k] for k in names] + [x])
    t_grads = dict(zip(names + ["pts"], (g.numpy() for g in grads)))
    j_grads = {k: np.asarray(v) for k, v in gp.items()}
    j_grads["pts"] = np.asarray(gx)
    return raw.detach().numpy(), t_grads, np.asarray(j_raw), j_grads


@pytest.mark.parametrize("kw", [{}, dict(netdepth=2, skips=(0,), multires=4,
                                         multires_views=2)])
def test_plain_k4_k5_match_jax_f32(kw, monkeypatch):
    cfg, jp, pts, vd = _setup(2, **kw)
    raw, tg, jraw, jg = _both(cfg, jp, pts, vd, True, monkeypatch)
    _scaled_close(raw, jraw, 1e-4, "raw")
    for k in jg:
        _scaled_close(tg[k], jg[k], 1e-4, k)


def test_plain_k4_k5_match_jax_bf16(monkeypatch):
    cfg, jp, pts, vd = _setup(3)
    raw, tg, jraw, jg = _both(cfg, jp, pts, vd, False, monkeypatch)
    _scaled_close(raw, jraw, 1e-2, "raw")
    for k in jg:
        _scaled_close(tg[k], jg[k], 2e-2 if k == "pts" else 1e-2, k)


def test_plain_fused_matches_unfused(monkeypatch):
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk

    monkeypatch.setattr(tmk, "MATMUL_DTYPE", torch.float32)
    cfg, jp, pts, vd = _setup(4, n=200)
    t_cfg = NeRFModelConfig(**cfg)
    tp = nerf_params_from_jax(jp, device="cpu")
    x, d = torch.from_numpy(pts), torch.from_numpy(vd)
    fused = tmk.nerf_mlp_fused(tp, t_cfg, x, d)
    plain = apply_nerf(tp, t_cfg, positional_encoding(x, 10),
                       positional_encoding(d, 4))
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)
    names = list(tp)
    gf = torch.autograd.grad(fused.square().sum(), [tp[k] for k in names])
    gu = torch.autograd.grad(plain.square().sum(), [tp[k] for k in names])
    for k, a, b in zip(names, gf, gu):
        _scaled_close(a.numpy(), b.numpy(), 1e-5, k)


def test_d_pts_is_none_without_input_grad():
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk

    cfg, jp, pts, vd = _setup(5, n=100)
    tp = nerf_params_from_jax(jp, device="cpu")
    x = torch.from_numpy(pts)
    raw = tmk.nerf_mlp_fused(tp, NeRFModelConfig(**cfg), x,
                             torch.from_numpy(vd))
    raw.sum().backward()
    assert x.grad is None and tp["pts_0_w"].grad is not None
    dims = tmk.MlpDims.from_cfg(NeRFModelConfig(**cfg))
    xin = tmk.pack_input(x, torch.from_numpy(vd))
    fw, fb = (t.detach() for t in tmk.pack_params(tp, dims))
    d_xin, dw, db = tmk.mlp_backward(xin, fw, fb, torch.ones(xin.shape[0], 4),
                                     dims, input_grads=False)
    assert d_xin is None and dw.shape == fw.shape and db.shape == fb.shape


def test_no_viewdirs_takes_the_unfused_path():
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk
    from nerfail_tpu_torch.models.nerf import init_nerf_params
    from nerfail_tpu_torch.render import query_network

    cfg = NeRFModelConfig(netdepth=2, netwidth=32, use_viewdirs=False)
    p = init_nerf_params(torch.Generator().manual_seed(0), cfg, "cpu")
    pts = torch.rand(3, 5, 3)
    before = (tmk.mlp_forward.launches, tmk.mlp_backward.launches)
    raw = query_network(p, cfg, pts, None, use_pallas=None)
    want = apply_nerf(p, cfg, positional_encoding(pts.reshape(-1, 3), 10))
    torch.testing.assert_close(raw.reshape(-1, 4), want)
    assert (tmk.mlp_forward.launches, tmk.mlp_backward.launches) == before
    with pytest.raises(ValueError):
        tmk.nerf_mlp_fused(p, cfg, pts.reshape(-1, 3), None)
    with pytest.raises(ValueError):
        tmk.MlpDims.from_cfg(cfg)
