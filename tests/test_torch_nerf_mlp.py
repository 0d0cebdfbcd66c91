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


_K5_CFGS = {"8x256": {}, "2x64": dict(netdepth=2, netwidth=64),
            "skip": dict(netdepth=4, netwidth=128, skips=(1,))}


@pytest.mark.parametrize("name", sorted(_K5_CFGS))
def test_k5b_partition_covers_every_dw_entry_once(name):
    """K5b's row tiles cover each entry of the flat dW once, and its
    point splits cover every row of the stash once, at several n and SM
    counts (rows not a multiple of the chunk among them)."""
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk

    dims = tmk.MlpDims.from_cfg(NeRFModelConfig(**_K5_CFGS[name]))
    shapes = dims.w_shapes()
    offs = np.cumsum([0] + [k * n for k, n in shapes])
    hits = np.zeros(offs[-1], np.int64)
    tiles = tmk.wgrad_tiles(dims)
    for j, m0, rows in tiles:
        k, n = shapes[j]
        assert m0 % tmk.WGRAD_ROWS == 0 and rows % 16 == 0
        assert 16 <= rows <= tmk.WGRAD_ROWS
        assert n % 16 == 0 and n <= 256 and m0 + rows <= k
        hits[offs[j] + m0 * n:offs[j] + (m0 + rows) * n] += 1
    assert (hits == 1).all()
    ragged = 0
    for n_pts in (64, 4096, 65536, 65600, 196608, 262144):
        for sms in (1, 78, 132):
            chunk = tmk.wgrad_chunk(n_pts, len(tiles), sms)
            assert chunk % tmk.TILE == 0 and chunk > 0
            starts = range(0, n_pts, chunk)
            rows = [min(chunk, n_pts - s) for s in starts]
            assert sum(rows) == n_pts and min(rows) >= tmk.TILE
            ragged += n_pts % chunk != 0
    assert ragged > 0


def test_k5_stash_planes_match_a_hand_count():
    """The per-point stash of K5 at 8×256 (skip after layer 4): A planes
    Σ kin_i + W + (W + vd_pad) + W/2, dZ planes D·W + W + W/2 + 16."""
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk

    dims = tmk.MlpDims.from_cfg(NeRFModelConfig())
    a, z = tmk.stash_planes(dims)
    kin = [64, 256, 256, 256, 256, 256 + 64, 256, 256]
    assert a == kin + [256, 256 + 32, 128]
    assert z == [256] * 9 + [128, 16]
    assert sum(a) == 2592 and sum(z) == 2448
    # bytes per point of bf16, and the stash at a train step's points
    assert 2 * (sum(a) + sum(z)) == 10080
    assert 2 * (sum(a) + sum(z)) * 262144 / 2 ** 30 == pytest.approx(2.461,
                                                                      abs=1e-3)
    small = tmk.MlpDims.from_cfg(NeRFModelConfig(netdepth=2, netwidth=64,
                                                 skips=(0,), multires=4,
                                                 multires_views=2))
    assert tmk.stash_planes(small) == ([64, 64 + 64, 64, 64 + 32, 32],
                                       [64, 64, 64, 32, 16])


@pytest.mark.parametrize("input_grads", [False, True])
def test_mlp_backward_on_cpu_is_the_plain_version(input_grads):
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk

    cfg, jp, pts, vd = _setup(6, n=128)
    tp = nerf_params_from_jax(jp, device="cpu")
    dims = tmk.MlpDims.from_cfg(NeRFModelConfig(**cfg))
    xin = tmk.pack_input(torch.from_numpy(pts), torch.from_numpy(vd))
    fw, fb = (t.detach() for t in tmk.pack_params(tp, dims))
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(xin.shape[0], 4)).astype(np.float32))
    before = tmk.mlp_backward.launches
    got = tmk.mlp_backward(xin, fw, fb, g, dims, input_grads)
    want = tmk.mlp_backward_plain(xin, fw, fb, g, dims, input_grads)
    assert tmk.mlp_backward.launches == before
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(_K5_CFGS))
def test_weight_fragments_follow_the_mma_register_order(name):
    """The packed weights hold every W_j (forward) and every W_jᵀ
    (backward) once, each 16×16 fragment in the register order of
    mma.sync.m16n8k16's B operand: lane (g, t) holds rows 2t, 2t + 1,
    2t + 8, 2t + 9 of column g, then of column 8 + g."""
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk

    dims = tmk.MlpDims.from_cfg(NeRFModelConfig(**_K5_CFGS[name]))
    shapes = dims.w_shapes()
    total = sum(k * n for k, n in shapes)
    order = tmk.fragment_order(dims)
    assert order.shape == (2 * total,)
    for half in (order[:total], order[total:]):
        assert (np.sort(half) == np.arange(total)).all()
    o = 0
    for k, n in shapes:
        w = np.arange(o, o + k * n).reshape(k, n)
        for half, b in ((0, w), (1, w.T)):
            kl, nl = b.shape
            frags = order[half * total + o:half * total + o + k * n].reshape(
                kl // 16, nl // 16, 32, 8)
            blocks = b.reshape(kl // 16, 16, nl // 16, 16)
            for lane in range(32):
                g, t = divmod(lane, 4)
                rows = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
                for h in (0, 1):
                    want = blocks[:, rows][..., 8 * h + g].transpose(0, 2, 1)
                    got = frags[:, :, lane, 4 * h:4 * h + 4]
                    assert (got == want).all(), (name, half, lane, h)
        o += k * n
