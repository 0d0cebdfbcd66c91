"""PyTorch port, slice 3: the renderer against the JAX package and the
reference goldens.

Both packages take the same parameters (JAX init carried over by
`nerf_params_from_jax`), rays and injected uniforms (t_rand, u_pdf).
Tolerances: rtol 1e-4, atol 1e-5 on every map, `z_std` and `pts_max`
(f32 sums, cumsum and cumprod in other orders; the reference goldens use
the JAX package's own 2e-4 / 2e-5). The unfused path (use_pallas=False)
is compared in f32; the port's fused path with f32 operands too.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu.config import NeRFModelConfig as JM  # noqa: E402
from nerfail_tpu.config import RenderConfig as JR  # noqa: E402
from nerfail_tpu.models.nerf import init_nerf_params as j_init  # noqa: E402
from nerfail_tpu_torch.config import NeRFModelConfig, RenderConfig  # noqa: E402
from nerfail_tpu_torch.models.nerf import nerf_params_from_jax  # noqa: E402

MODEL = dict(netdepth=2, netwidth=32, skips=(0,), multires=4,
             multires_views=2)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(seed):
    jc = jax.device_get(j_init(jax.random.PRNGKey(seed), JM(**MODEL)))
    jf = jax.device_get(j_init(jax.random.PRNGKey(seed + 1), JM(**MODEL)))
    return (jc, jf, nerf_params_from_jax(jc, device="cpu"),
            nerf_params_from_jax(jf, device="cpu"))


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32) + np.float32(
        [0, 0, 4])
    d = rng.normal(0, 0.15, (n, 3)).astype(np.float32) + np.float32([0, 0, -1])
    return o, d


def _jax_render():
    from nerfail_tpu.render import render_rays

    return jax.jit(render_rays, static_argnames=("mcfg", "rcfg", "train"))


def _compare(got, want, keys, rtol=1e-4, atol=1e-5):
    for k in keys:
        np.testing.assert_allclose(got[k].detach().cpu().numpy(),
                                   np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


KEYS = ("rgb_map", "disp_map", "acc_map", "depth_map", "rgb0", "disp0",
        "acc0", "z_std", "pts_max")


@pytest.mark.parametrize("fused", [False, True])
def test_render_rays_matches_jax(fused, monkeypatch):
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk
    from nerfail_tpu_torch.render import render_rays

    monkeypatch.setattr(tmk, "MATMUL_DTYPE", torch.float32)
    jc, jf, tc, tf = _params(0)
    n, S, I = 40, 16, 24
    o, d = _rays(1, n)
    rng = np.random.default_rng(2)
    t_rand = rng.uniform(size=(n, S)).astype(np.float32)
    u = rng.uniform(size=(n, I)).astype(np.float32)
    rc = dict(N_samples=S, N_importance=I, white_bkgd=True)
    want = _jax_render()(jc, jf, JM(**MODEL), JR(**rc, use_pallas=False),
                    jnp.asarray(o), jnp.asarray(d), train=True,
                    t_rand=jnp.asarray(t_rand), u_pdf=jnp.asarray(u))
    got = render_rays(tc, tf, NeRFModelConfig(**MODEL),
                      RenderConfig(**rc, use_pallas=None if fused else False),
                      torch.from_numpy(o), torch.from_numpy(d), train=True,
                      t_rand=torch.from_numpy(t_rand), u_pdf=torch.from_numpy(u))
    _compare(got, want, KEYS)


def test_render_rays_coarse_only_and_test_time():
    from nerfail_tpu_torch.render import render_rays

    j_render = _jax_render()
    jc, _, tc, _ = _params(3)
    o, d = _rays(4, 30)
    for rc in (dict(N_samples=12, N_importance=0, white_bkgd=False),
               dict(N_samples=12, N_importance=12, lindisp=True)):
        want = j_render(jc, None, JM(**MODEL), JR(**rc, use_pallas=False),
                        jnp.asarray(o), jnp.asarray(d))
        got = render_rays(tc, None, NeRFModelConfig(**MODEL),
                          RenderConfig(**rc, use_pallas=False),
                          torch.from_numpy(o), torch.from_numpy(d))
        _compare(got, want, [k for k in KEYS if k in want])


def test_render_goldens():
    """tests/test_parity.py's coarse → fine tile: keras-format weights and
    the reference's seeded hooks give the reference's maps."""
    from nerfail_tpu_torch.models.nerf import load_weights_from_keras
    from nerfail_tpu_torch.render import render_rays

    g = np.load("tests/golden/reference_goldens.npz")
    mcfg = NeRFModelConfig(netdepth=2, netwidth=32, skips=(0,), multires=4,
                           multires_views=2, density_init_bias=0.0)
    rcfg = RenderConfig(N_samples=8, N_importance=8, perturb=1.0,
                        white_bkgd=True, near=2.0, far=6.0, use_pallas=False)
    pc = load_weights_from_keras(mcfg, [g[f"render/weights_coarse/{i}"]
                                        for i in range(12)], device="cpu")
    pf = load_weights_from_keras(mcfg, [g[f"render/weights_fine/{i}"]
                                        for i in range(12)], device="cpu")
    np.random.seed(0)
    t_rand = np.random.rand(4, 8).astype(np.float32)
    np.random.seed(0)
    u = np.random.rand(4, 8).astype(np.float32)
    out = render_rays(pc, pf, mcfg, rcfg, torch.from_numpy(g["render/rays_o"]),
                      torch.from_numpy(g["render/rays_d"]), train=True,
                      t_rand=torch.from_numpy(t_rand),
                      u_pdf=torch.from_numpy(u))
    for k in ("rgb_map", "disp_map", "acc_map", "rgb0", "disp0", "acc0",
              "z_std"):
        ours = out[k].detach().numpy()
        ref = g[f"render/{k}"]
        # empty rays: the reference's disp is 0/0 = nan, ours the guarded
        # 1e10 sentinel; both mean "no hit"
        empty = ~np.isfinite(ref)
        if empty.any():
            assert np.all(ours[empty] > 1e9), k
        np.testing.assert_allclose(ours[~empty], ref[~empty], rtol=2e-4,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("ndc", [False, True])
def test_render_full_image_matches_jax(ndc):
    from nerfail_tpu.render import render_full_image as j_full
    from nerfail_tpu_torch.data.poses import pose_spherical
    from nerfail_tpu_torch.render import render_full_image

    jc, jf, tc, tf = _params(5)
    H = W = 16
    focal = 20.0
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    if ndc:       # a forward-facing camera, as LLFF's
        c2w = np.eye(4, dtype=np.float32)
    else:
        c2w = pose_spherical(30.0, -30.0, 4.0).astype(np.float32)
    rc = dict(N_samples=8, N_importance=8, chunk=100, ndc=ndc)
    want = j_full(jc, jf, JM(**MODEL), JR(**rc, use_pallas=False), H, W,
                  jnp.asarray(K), jnp.asarray(c2w))
    got = render_full_image(tc, tf, NeRFModelConfig(**MODEL),
                            RenderConfig(**rc, use_pallas=False), H, W, K, c2w)
    assert got["pts_max"].shape == (H, W, 3)
    _compare(got, want, KEYS)
