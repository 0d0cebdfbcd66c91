"""PyTorch port, slice 3: the NeRF trainer, its schedule, sampler and
checkpoints, and coordinate extraction, against the JAX package.

Both packages take the same parameters (JAX init carried over), rays and
injected uniforms. Tolerances:
  * one train step: loss at rtol 1e-5; every gradient at 1e-4 of the
    tensor's largest entry (f32 sums in other orders through the
    renderer); parameters after the Adam step at rtol 1e-5 and atol 1e-8
    (2·10⁻⁵ of lr: the step lr·g/(|g| + ε) moves by lr·ε·Δg/g² when g
    moves by Δg), except where 0 < |g| < 100·ε: there a last-bit gradient
    difference moves the step by up to lr, and those entries are held to
    the step from the port's own gradient (rtol 1e-5) and to the sign of
    JAX's step where |g| ≥ ε (ROADMAP Queue 3);
  * learning rates at rtol 1e-6 against optax's schedule;
  * coordinate maps and tables at 16²: `pts_max` at atol 1e-5 on at least
    98 % of pixels (a near-tie of the argmax may pick a neighbouring
    sample); weights against the JAX package's tables at atol 3e-3,
    because its CPU k-NN computes |q|² + |p|² − 2q·p, which loses ≈ 1e-3
    near d = 0 (ROADMAP Queue 3); distances against its exact KD-tree path
    at rtol 1e-5 and indices equal to it wherever the distance is not
    tied within that tolerance.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu.config import ExperimentConfig as JE  # noqa: E402
from nerfail_tpu.config import NeRFModelConfig as JM  # noqa: E402
from nerfail_tpu.config import RenderConfig as JR  # noqa: E402
from nerfail_tpu.config import TrainConfig as JT  # noqa: E402
from nerfail_tpu.models.nerf import init_nerf_params as j_init  # noqa: E402
from nerfail_tpu_torch.config import (  # noqa: E402
    ExperimentConfig, NeRFModelConfig, RenderConfig, TrainConfig,
)
from nerfail_tpu_torch.models.nerf import nerf_params_from_jax  # noqa: E402

MODEL = dict(netdepth=2, netwidth=32, skips=(0,), multires=4,
             multires_views=2)
EPS = 1e-8


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_params(seed):
    return {"coarse": jax.device_get(j_init(jax.random.PRNGKey(seed),
                                            JM(**MODEL))),
            "fine": jax.device_get(j_init(jax.random.PRNGKey(seed + 1),
                                          JM(**MODEL)))}


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax(fused, monkeypatch):
    import optax

    from nerfail_tpu.render import render_rays as j_render
    from nerfail_tpu.train.nerf_trainer import make_optimizer as j_opt
    import nerfail_tpu_torch.ops.cuda.mlp_kernel as tmk
    from nerfail_tpu_torch.train.nerf_trainer import (
        NeRFTrainState, make_optimizer, make_train_step,
    )

    monkeypatch.setattr(tmk, "MATMUL_DTYPE", torch.float32)
    n, S, I = 64, 16, 16
    rc = dict(N_samples=S, N_importance=I)
    tcfg = dict(N_rand=n, lrate=5e-4)
    rng = np.random.default_rng(0)
    o = (rng.uniform(-0.2, 0.2, (n, 3)) + [0, 0, 4]).astype(np.float32)
    d = (rng.normal(0, 0.15, (n, 3)) + [0, 0, -1]).astype(np.float32)
    target = rng.uniform(size=(n, 3)).astype(np.float32)
    t_rand = rng.uniform(size=(n, S)).astype(np.float32)
    u = rng.uniform(size=(n, I)).astype(np.float32)

    jp = _jax_params(1)
    jm, jr = JM(**MODEL), JR(**rc, use_pallas=False)

    def loss_fn(p):
        out = j_render(p["coarse"], p["fine"], jm, jr, jnp.asarray(o),
                       jnp.asarray(d), train=True, t_rand=jnp.asarray(t_rand),
                       u_pdf=jnp.asarray(u))
        return (jnp.mean((out["rgb_map"] - target) ** 2)
                + jnp.mean((out["rgb0"] - target) ** 2))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    opt = j_opt(JT(**tcfg))
    upd, _ = opt.update(jgrads, opt.init(jp), jp)
    jnew = jax.device_get(optax.apply_updates(jp, upd))

    params = {k: nerf_params_from_jax(v, device="cpu") for k, v in jp.items()}
    tc = TrainConfig(**tcfg)
    state = NeRFTrainState(params, make_optimizer(tc, params), 0)
    p0 = {k: {n_: t.detach().clone() for n_, t in v.items()}
          for k, v in params.items()}
    step = make_train_step(NeRFModelConfig(**MODEL),
                           RenderConfig(**rc, use_pallas=None if fused
                                        else False), tc)
    batch = {"rays_o": torch.from_numpy(o), "rays_d": torch.from_numpy(d),
             "target": torch.from_numpy(target),
             "t_rand": torch.from_numpy(t_rand), "u_pdf": torch.from_numpy(u)}
    m = step(state, batch, None, (16, 16), 20.0)
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    n_firm = 0
    for net in ("coarse", "fine"):
        for k, t in params[net].items():
            g = t.grad.numpy()
            jg = np.asarray(jgrads[net][k])
            scale = max(float(np.abs(jg).max()), 1e-12)
            assert np.abs(g - jg).max() <= 1e-4 * scale, (net, k)
            loose = (np.abs(g) < 100 * EPS) & (g != 0)
            new = t.detach().numpy()
            np.testing.assert_allclose(new[~loose], jnew[net][k][~loose],
                                       rtol=1e-5, atol=1e-8,
                                       err_msg=f"{net}.{k}")
            start = p0[net][k].numpy()[loose]
            gl = g[loose].astype(np.float64)
            own = -5e-4 * gl / (np.abs(gl) + EPS)
            np.testing.assert_allclose(new[loose], start + own, rtol=1e-5,
                                       atol=1e-9)
            firm = np.abs(gl) >= EPS
            n_firm += int(firm.sum())
            assert (np.sign(jnew[net][k][loose] - start)[firm]
                    == np.sign(own)[firm]).all()


def test_lr_schedule_matches_optax():
    import optax

    from nerfail_tpu_torch.train.nerf_trainer import lr_at

    tcfg = TrainConfig(lrate=5e-4, lrate_decay=250)
    sched = optax.exponential_decay(5e-4, transition_steps=250 * 1000,
                                    decay_rate=0.1)
    for s in (0, 1, 999, 125_000, 250_000, 600_000):
        np.testing.assert_allclose(lr_at(tcfg, s), float(sched(s)), rtol=1e-6)


@pytest.mark.parametrize("precrop,single", [(True, True), (False, True),
                                            (True, False)])
def test_ray_sampler_window(precrop, single):
    """Targets encode (image, y, x), so they show where each ray was drawn:
    inside the same window as the JAX sampler, reaching both ends."""
    from nerfail_tpu.train.nerf_trainer import _sample_rays_in_jit
    from nerfail_tpu_torch.train.nerf_trainer import (
        precrop_window, sample_rays,
    )

    N, H, W = 3, 20, 24
    n, y, x = np.meshgrid(np.arange(N), np.arange(H), np.arange(W),
                          indexing="ij")
    images = np.stack([n, y, x], -1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    b = sample_rays(torch.Generator().manual_seed(0), torch.from_numpy(images),
                    torch.from_numpy(poses), torch.from_numpy(K), 4000,
                    precrop, 0.5, single)
    t = b["target"].numpy()
    _, jd, jt = _sample_rays_in_jit(jax.random.PRNGKey(0),
                                    jnp.asarray(images), jnp.asarray(poses),
                                    jnp.asarray(K), 4000, precrop, 0.5, single)
    jt = np.asarray(jt)
    y_lo, y_hi, x_lo, x_hi = precrop_window(H, W, precrop, 0.5)
    for arr in (t, jt):
        assert arr[:, 1].min() == y_lo and arr[:, 1].max() == y_hi - 1
        assert arr[:, 2].min() == x_lo and arr[:, 2].max() == x_hi - 1
        assert (len(np.unique(arr[:, 0])) == 1) == single
    # the direction of each ray is that of its pixel (the pose is identity)
    d = b["rays_d"].numpy()
    np.testing.assert_allclose(d[:, 0], (t[:, 2] - K[0, 2]) / K[0, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(d[:, 1], -(t[:, 1] - K[1, 2]) / K[1, 1],
                               rtol=1e-6)
    del jd


def _mini(tmp_path=None, **train):
    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import make_box_scene

    cfg = ExperimentConfig(
        model=NeRFModelConfig(**MODEL),
        render=RenderConfig(N_samples=8, N_importance=8, chunk=256),
        train=TrainConfig(N_rand=64, precrop_iters=2, i_print=10 ** 9,
                          **train))
    scene = make_box_scene(n_train=4, n_val=1, n_test=1, H=16, W=16)
    return cfg, scene, white_background_composite(scene.images)


def test_checkpoint_and_auto_resume(tmp_path):
    """Two steps, a checkpoint, then a resumed run to step 4 gives the
    parameters and Adam state of an unbroken 4-step run, bit for bit."""
    from nerfail_tpu_torch.train.checkpoint import latest_checkpoint
    from nerfail_tpu_torch.train.nerf_trainer import train_nerf

    cfg, scene, t = _mini(i_weights=2)
    full = train_nerf(cfg, t, scene.poses, scene.K, scene.i_train,
                      n_iters=4, device="cpu")
    logdir = str(tmp_path / "run")
    train_nerf(cfg, t, scene.poses, scene.K, scene.i_train, n_iters=2,
               logdir=logdir, device="cpu")
    assert latest_checkpoint(logdir).endswith("000002.ckpt")
    resumed = train_nerf(cfg, t, scene.poses, scene.K, scene.i_train,
                         n_iters=4, logdir=logdir, device="cpu")
    assert resumed.step == full.step == 4
    assert latest_checkpoint(logdir).endswith("000004.ckpt")
    for net in ("coarse", "fine"):
        for k, v in full.params[net].items():
            assert torch.equal(v, resumed.params[net][k]), (net, k)
    sa = full.opt_state.state_dict()["state"]
    sb = resumed.opt_state.state_dict()["state"]
    for i in sa:
        assert torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])
    import os
    assert os.path.exists(os.path.join(logdir, "args.txt"))


def test_extract_coord_maps_and_tables_match_jax():
    from nerfail_tpu.config import PointSetConfig as JP
    from nerfail_tpu.pointset.extract import (
        build_neighbor_tables as j_tables, extract_coord_maps as j_extract,
    )
    from nerfail_tpu_torch.config import PointSetConfig
    from nerfail_tpu_torch.pointset.extract import (
        build_neighbor_tables, build_point_set, extract_coord_maps,
    )

    _, scene, _ = _mini()
    jp = _jax_params(2)
    rc = dict(N_samples=16, N_importance=16, chunk=100, use_pallas=False)
    jcfg = JE(model=JM(**MODEL), render=JR(**rc))
    cfg = ExperimentConfig(model=NeRFModelConfig(**MODEL),
                           render=RenderConfig(**rc))
    params = {k: nerf_params_from_jax(v, device="cpu") for k, v in jp.items()}
    poses = scene.poses[:3]
    coords, rgbs = extract_coord_maps(params, cfg, poses, 16, 16, scene.K)
    jcoords, jrgbs = j_extract(jp, jcfg, poses, 16, 16, scene.K)
    assert coords.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(rgbs, jrgbs, rtol=1e-4, atol=1e-5)
    same = np.all(np.abs(coords - jcoords) <= 1e-5 + 1e-5 * np.abs(jcoords),
                  -1)
    assert same.mean() >= 0.98, same.mean()
    S = build_point_set(jcoords[:2])
    assert S.shape == (2 * 256, 3)
    w, idx = build_neighbor_tables(jcoords, S, PointSetConfig(), device="cpu")
    jw, jidx = j_tables(jcoords, S, JP(s_chunk=256, q_chunk=1024))
    np.testing.assert_allclose(w, jw, rtol=1e-5, atol=3e-3)
    from nerfail_tpu.pointset.knn_build import build_index_and_dist as j_knn

    for v in range(3):
        # 9 neighbours, so that a tie of the 8th with the 9th shows
        jd9, ji9 = j_knn(jcoords[v], S, k=9, method="host")
        jd9, ji9 = np.asarray(jd9), np.asarray(ji9)
        jd, ji = jd9[..., :8], ji9[..., :8]
        d = np.linalg.norm(jcoords[v][..., None, :] - S[idx[v]], axis=-1)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-7)
        gap = np.abs(np.diff(jd9, axis=-1)) > 1e-5 * jd9[..., 1:] + 1e-7
        untied = gap[..., :8].copy()
        untied[..., 1:] &= gap[..., :7]
        assert (idx[v][untied] == ji[untied]).all()


@pytest.mark.slow
def test_mini_nerf_learns():
    """tests/test_e2e.py's mini scene in the port: 400 steps at 24², test
    PSNR above 14 dB."""
    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import make_box_scene
    from nerfail_tpu_torch.train.nerf_trainer import eval_psnr, train_nerf

    cfg = ExperimentConfig(
        model=NeRFModelConfig(netdepth=2, netwidth=64, multires=6,
                              multires_views=2),
        render=RenderConfig(N_samples=16, N_importance=16, chunk=1024),
        train=TrainConfig(N_rand=256, precrop_iters=20, i_print=10 ** 9))
    scene = make_box_scene(n_train=10, n_val=1, n_test=3, H=24, W=24)
    targets = white_background_composite(scene.images)
    state = train_nerf(cfg, targets, scene.poses, scene.K, scene.i_train,
                       n_iters=400, device="cpu")
    psnr = eval_psnr(state, cfg, targets, scene.poses, scene.K, scene.i_test)
    assert psnr > 14.0, f"mini NeRF failed to converge: {psnr:.1f} dB"
