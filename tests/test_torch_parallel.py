"""PyTorch port, multi-GPU: parallel/ on torch.distributed, against the JAX
package's parallel/ and the port's single process.

Ranks are real processes: `parallel.launch.spawn` starts 2 (or 4) gloo
ranks on the CPU that meet on a FileStore in `tmp_path`, one thread each;
the rank programs live in nerfail_tpu_torch/tools/parallel_checks.py,
which imports no JAX. Tolerances:
  * the pure helpers (`mesh_shape_for`, `view_slice_for`,
    `nerf_param_pspec`) and every layout equal the JAX package's exactly;
  * `segment_sum_sharded` against the unsharded plain sum at rtol 1e-6
    (the same f32 products, summed per rank and then across ranks);
  * a sharded train step on injected rays and uniforms: mesh (1, 2) equal
    to one process bit for bit, both on one thread (the model ranks render
    the same rays on the same gathered weights); mesh (2, 1) and JAX's sharded
    step at the loss's rtol 1e-5 and the parameters' rtol 1e-5 and atol
    1e-6 (0.2 % of lr, the largest Adam step), except the entries whose
    gradient is below 100·ε, where a last-bit gradient difference moves
    Adam's step by up to lr: those within 2·lr (ROADMAP Queue 3, Adam's
    first step near ε);
  * the parameters bit-equal across ranks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.parallel.launch import spawn  # noqa: E402
from nerfail_tpu_torch.tools import parallel_checks as pc  # noqa: E402

MODEL = dict(netdepth=2, netwidth=64)
RENDER = dict(N_samples=8, N_importance=8, chunk=256)
TRAIN = dict(N_rand=64, precrop_iters=0)
CFG = {"model": MODEL, "render": RENDER, "train": TRAIN}
LR = 5e-4
EPS = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _spawn(tmp, fn, n=2, model_parallel=1, args=()):
    return spawn(fn, n, backend="gloo", store_dir=str(tmp),
                 device_type="cpu", model_parallel=model_parallel,
                 args=args, num_threads=1)


def _jax_params(seed=0):
    from nerfail_tpu.config import NeRFModelConfig as JM
    from nerfail_tpu.models.nerf import init_nerf_params

    return {"coarse": jax.device_get(init_nerf_params(
                jax.random.PRNGKey(seed), JM(**MODEL))),
            "fine": jax.device_get(init_nerf_params(
                jax.random.PRNGKey(seed + 1), JM(**MODEL)))}


# ---- the pure helpers -------------------------------------------------------


def test_mesh_shape_for_matches_jax():
    from nerfail_tpu.parallel.mesh import mesh_shape_for as j_shape
    from nerfail_tpu_torch.parallel.mesh import mesh_shape_for

    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        assert mesh_shape_for(n) == j_shape(n), n
        for mp in (1, 2, 4):
            if n % mp == 0:
                assert mesh_shape_for(n, mp) == j_shape(n, mp), (n, mp)


def test_view_slice_for_matches_jax():
    from nerfail_tpu.parallel.multihost import view_slice_for as j_slice
    from nerfail_tpu_torch.parallel.multihost import view_slice_for

    for n_views in (1, 7, 100, 400):
        for pc_ in (1, 2, 3, 4, 8):
            for pi in range(pc_):
                assert view_slice_for(n_views, pc_, pi) == \
                    j_slice(n_views, pc_, pi)


def test_nerf_param_pspec_matches_jax():
    from nerfail_tpu.parallel.shard import nerf_param_pspec as j_spec
    from nerfail_tpu_torch.parallel.shard import nerf_param_pspec

    names = list(_jax_params()["coarse"]) + ["output_w", "output_b",
                                             "other", "pts_9_b"]
    for name in names:
        assert nerf_param_pspec(name) == tuple(j_spec(name)), name


def test_single_process_helpers():
    from nerfail_tpu_torch.parallel.mesh import make_mesh
    from nerfail_tpu_torch.parallel.multihost import (
        initialize_distributed, process_view_slice,
    )

    initialize_distributed()               # no-ops, as the JAX package's
    initialize_distributed(num_processes=1)
    assert process_view_slice(10) == slice(0, 10)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2)


# ---- layouts over 4 gloo ranks, mesh (2, 2) ---------------------------------


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    params = _jax_params()["coarse"]
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    views = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    out = _spawn(tmp_path_factory.mktemp("layouts"), pc.layouts, n=4,
                 model_parallel=2, args=(params, x, views))
    return params, x, views, out


def test_mesh_coordinates_are_row_major(layouts):
    *_, out = layouts
    assert [r["coords"] for r in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_shard_nerf_params_match_jax_shards(layouts):
    """Each rank's shard is the JAX mesh's addressable shard of its model
    index on make_mesh(2, model_parallel=2)."""
    from nerfail_tpu.parallel.mesh import make_mesh
    from nerfail_tpu.parallel.shard import shard_nerf_params

    params, _, _, out = layouts
    mesh = make_mesh(2, model_parallel=2)
    sharded = shard_nerf_params(mesh, {k: jnp.asarray(v)
                                       for k, v in params.items()})
    model_devices = list(mesh.devices[0])
    for k, arr in sharded.items():
        by_dev = {s.device: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for r in out:
            want = by_dev[model_devices[r["coords"][1]]]
            np.testing.assert_array_equal(r["shards"][k], want, err_msg=k)


def test_gather_nerf_params_round_trip(layouts):
    params, _, _, out = layouts
    for r in out:
        for k, v in params.items():
            np.testing.assert_array_equal(r["gathered"][k], v, err_msg=k)


def test_shard_batch_layout(layouts):
    _, x, _, out = layouts
    for r in out:
        d = r["coords"][0]
        np.testing.assert_array_equal(r["batch"]["o"].numpy(),
                                      x[d * 8:(d + 1) * 8])
        assert float(r["batch"]["s"]) == 3.0      # scalars stay whole


def test_host_local_and_replicate_global(layouts):
    """host_local_to_global keeps each rank's view_slice_for shard (the
    last one shorter); replicate_global gives every rank rank 0's copy."""
    from nerfail_tpu_torch.parallel.multihost import view_slice_for

    _, x, views, out = layouts
    got = np.concatenate([r["local"] for r in out])
    np.testing.assert_array_equal(got, views)
    for r in out:
        np.testing.assert_array_equal(
            r["local"], views[view_slice_for(len(views), 4, r["rank"])])
        np.testing.assert_array_equal(r["replicated"], x)


def test_host_local_to_global_rejects_mismatched_shards(tmp_path):
    with pytest.raises(RuntimeError, match="trailing dims"):
        _spawn(tmp_path, pc.host_local_mismatch)


def test_spawn_reraises_a_rank_failure(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        _spawn(tmp_path, pc.fail_on_rank_1)


# ---- segment_sum_sharded ----------------------------------------------------


@pytest.fixture(scope="module")
def segsum_runs(tmp_path_factory):
    rng = np.random.default_rng(3)
    V, HW, C, M = 4, 48, 4, 60
    g = rng.normal(size=(V, HW, C)).astype(np.float32)
    idx = rng.integers(0, M, (V, HW, 8)).astype(np.int32)
    w = rng.uniform(size=(V, HW, 8)).astype(np.float32)
    out = _spawn(tmp_path_factory.mktemp("segsum"),
                 pc.segment_sum_sharded_run, args=(g, idx, w, M))
    return (g, idx, w, M), out


@pytest.mark.parametrize("reduce", [True, False])
def test_segment_sum_sharded_matches_unsharded(segsum_runs, reduce):
    from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
        build_batched_csr_plan, build_csr_plan, segment_sum_plain,
    )

    (g, idx, w, M), runs = segsum_runs
    C = g.shape[-1]
    out = [r[reduce] for r in runs]
    gt, it, wt = (torch.from_numpy(a) for a in (g, idx, w))
    if reduce:
        want = segment_sum_plain(gt.reshape(-1, C),
                                 build_csr_plan(it, wt, M)).numpy()
        for r in out:
            np.testing.assert_allclose(r, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out[0], out[1])
    else:
        want = segment_sum_plain(gt.reshape(-1, C),
                                 build_batched_csr_plan(it, wt, M)).numpy()
        np.testing.assert_allclose(np.concatenate(out), want, rtol=1e-6)


# ---- the sharded train step -------------------------------------------------


def _batch(n=64):
    rng = np.random.default_rng(0)
    return {
        "rays_o": (rng.uniform(-0.2, 0.2, (n, 3)) + [0, 0, 4]
                   ).astype(np.float32),
        "rays_d": (rng.normal(0, 0.15, (n, 3)) + [0, 0, -1]
                   ).astype(np.float32),
        "target": rng.uniform(size=(n, 3)).astype(np.float32),
        "t_rand": rng.uniform(size=(n, RENDER["N_samples"])
                              ).astype(np.float32),
        "u_pdf": rng.uniform(size=(n, RENDER["N_importance"])
                             ).astype(np.float32),
    }


def _single_step(params0, batch):
    from nerfail_tpu_torch.config import (
        NeRFModelConfig, RenderConfig, TrainConfig,
    )
    from nerfail_tpu_torch.models.nerf import nerf_params_from_jax
    from nerfail_tpu_torch.train.nerf_trainer import (
        NeRFTrainState, make_optimizer, make_train_step,
    )

    params = {k: nerf_params_from_jax(v, device="cpu")
              for k, v in params0.items()}
    tcfg = TrainConfig(**TRAIN)
    state = NeRFTrainState(params, make_optimizer(tcfg, params), 0)
    step = make_train_step(NeRFModelConfig(**MODEL), RenderConfig(**RENDER),
                           tcfg)
    m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
             None, (16, 16), 0.0)
    grads = {net: {k: t.grad.numpy() for k, t in params[net].items()}
             for net in params}
    new = {net: {k: t.detach().numpy() for k, t in params[net].items()}
           for net in params}
    return float(m["loss"]), new, grads


def _jax_sharded_step(params0, batch, model_parallel):
    """The JAX step's loss, gradient and Adam update on sharded params
    and a data-sharded ray batch (make_mesh(2, model_parallel)), on the
    same rays and uniforms."""
    import optax

    from nerfail_tpu.config import NeRFModelConfig as JM
    from nerfail_tpu.config import RenderConfig as JR
    from nerfail_tpu.config import TrainConfig as JT
    from nerfail_tpu.parallel.mesh import make_mesh
    from nerfail_tpu.parallel.shard import shard_batch, shard_nerf_params
    from nerfail_tpu.render import render_rays
    from nerfail_tpu.train.nerf_trainer import make_optimizer

    mesh = make_mesh(2, model_parallel=model_parallel)
    jm, jr = JM(**MODEL), JR(**RENDER, use_pallas=False)
    p = {k: shard_nerf_params(mesh, {n: jnp.asarray(v)
                                     for n, v in params0[k].items()})
         for k in params0}
    b = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})

    def loss_fn(p):
        out = render_rays(p["coarse"], p["fine"], jm, jr, b["rays_o"],
                          b["rays_d"], train=True, t_rand=b["t_rand"],
                          u_pdf=b["u_pdf"])
        return (jnp.mean((out["rgb_map"] - b["target"]) ** 2)
                + jnp.mean((out["rgb0"] - b["target"]) ** 2))

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p)
        opt = make_optimizer(JT(**TRAIN))
        upd, _ = opt.update(grads, opt.init(p), p)
        new = optax.apply_updates(p, upd)
    return (float(loss), jax.device_get(new), jax.device_get(grads))


def _assert_step_close(new, want, grads, what):
    """new ≈ want at rtol 1e-5 / atol 1e-6; entries with 0 < |g| < 100·ε
    within 2·lr (Adam's step there turns on the gradient's last bits)."""
    for net in want:
        for k in want[net]:
            g = np.asarray(grads[net][k])
            loose = (np.abs(g) < 100 * EPS) & (g != 0)
            a, b = new[net][k], np.asarray(want[net][k])
            np.testing.assert_allclose(a[~loose], b[~loose], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{what} {net}.{k}")
            assert np.all(np.abs(a[loose] - b[loose]) <= 2 * LR + 1e-7)


@pytest.fixture(scope="module")
def train_steps(tmp_path_factory):
    params0, batch = _jax_params(), _batch()
    torch.set_num_threads(1)           # the ranks' thread count: the same
    single = _single_step(params0, batch)   # sums in the same order
    torch.set_num_threads(2)
    out = {mp: _spawn(tmp_path_factory.mktemp(f"train{mp}"),
                      pc.train_step_run, model_parallel=mp,
                      args=(CFG, params0, batch, (16, 16)))
           for mp in (1, 2)}
    return params0, batch, single, out


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_sharded_train_step_matches_single_process(train_steps,
                                                   model_parallel):
    _, _, (loss, new, grads), out = train_steps
    ranks = out[model_parallel]
    for net in new:
        for k in new[net]:
            np.testing.assert_array_equal(ranks[0]["params"][net][k],
                                          ranks[1]["params"][net][k])
    if model_parallel == 2:          # mesh (1, 2): the same rays, exactly
        assert ranks[0]["losses"] == [loss]
        for net in new:
            for k in new[net]:
                np.testing.assert_array_equal(ranks[0]["params"][net][k],
                                              new[net][k])
        assert ranks[1]["shards"]["pts_0_w"].shape == (
            new["coarse"]["pts_0_w"].shape[0],
            new["coarse"]["pts_0_w"].shape[1] // 2)
    else:
        np.testing.assert_allclose(ranks[0]["losses"][0], loss, rtol=1e-5)
        _assert_step_close(ranks[0]["params"], new, grads, "(2, 1)")


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_sharded_train_step_matches_jax_mesh(train_steps, model_parallel):
    params0, batch, _, out = train_steps
    jloss, jnew, jgrads = _jax_sharded_step(params0, batch, model_parallel)
    ranks = out[model_parallel]
    np.testing.assert_allclose(ranks[0]["losses"][0], jloss, rtol=1e-5)
    _assert_step_close(ranks[0]["params"], jnew, jgrads,
                       f"model_parallel={model_parallel}")


def test_multi_step_window_on_a_mesh_equals_eager_steps(tmp_path):
    """make_multi_train_step over a (2, 1) mesh on the CPU runs the k-step
    program eagerly: the same as k sharded make_train_step calls on the
    same (seed, i) draws, bit for bit."""
    images = np.random.default_rng(1).uniform(size=(2, 16, 16, 3)
                                              ).astype(np.float32)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    poses[:, 2, 3] = 4.0
    K = np.array([[10.0, 0, 8.0], [0, 10.0, 8.0], [0, 0, 1]], np.float32)
    out = _spawn(tmp_path, pc.multi_step_run, args=(CFG, 3, images, poses,
                                                    K, 2))
    for r in out:
        for k, v in r["window"].items():
            np.testing.assert_array_equal(v, r["eager"][k], err_msg=k)
            np.testing.assert_array_equal(v, out[0]["window"][k])


# ---- train_nerf on a mesh, its checkpoints, and the CLI ---------------------


def _box(tmp):
    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import make_box_scene

    sc = make_box_scene(n_train=3, n_val=1, n_test=1, H=16, W=16)
    return white_background_composite(sc.images), sc.poses, sc.K, sc.i_train


def test_train_nerf_on_a_mesh_resumes_both_ways(tmp_path):
    """train_nerf on a (1, 2) mesh writes one-device checkpoints: it
    resumes its own, an unsharded run resumes it, and it resumes an
    unsharded one; each matches the unbroken single-process run."""
    from nerfail_tpu_torch.config import (
        ExperimentConfig, NeRFModelConfig, RenderConfig, TrainConfig,
    )
    from nerfail_tpu_torch.train.nerf_trainer import train_nerf

    images, poses, K, i_train = _box(tmp_path)
    cfg_kw = dict(CFG, train=dict(TRAIN, precrop_iters=2, i_weights=2))
    cfg = ExperimentConfig(model=NeRFModelConfig(**MODEL),
                           render=RenderConfig(**RENDER),
                           train=TrainConfig(**cfg_kw["train"]))
    ref = train_nerf(cfg, images, poses, K, i_train, logdir=None,
                     n_iters=6, device="cpu")
    ref_p = {k: v.detach().numpy() for k, v in ref.params["coarse"].items()}

    a = tmp_path / "a"
    first, on_mesh = zip(*_spawn(
        tmp_path, pc.train_nerf_run, model_parallel=2,
        args=(cfg_kw, images, poses, K, i_train, str(a), (4, 6))))
    assert first[0]["step"] == 4 and (a / "000004.ckpt").exists()
    assert (a / "000002.ckpt").exists() and (a / "args.txt").exists()
    assert on_mesh[0]["step"] == 6

    b = tmp_path / "b"
    train_nerf(cfg, images, poses, K, i_train, logdir=str(b), n_iters=4,
               device="cpu")
    from_single = [r[0] for r in _spawn(
        tmp_path, pc.train_nerf_run, model_parallel=2,
        args=(cfg_kw, images, poses, K, i_train, str(b), (6,)))]
    single_from_mesh = train_nerf(cfg, images, poses, K, i_train,
                                  ft_path=str(a / "000004.ckpt"),
                                  n_iters=6, device="cpu")
    for k, v in ref_p.items():
        for got in (on_mesh[0]["params"][k], on_mesh[1]["params"][k],
                    from_single[0]["params"][k],
                    single_from_mesh.params["coarse"][k].detach().numpy()):
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_cli_train_nerf_with_num_devices(tmp_path):
    """`cli train-nerf --num_devices 2 --model_parallel 1 --device cpu`
    end to end: two ranks, rank 0's checkpoint."""
    from nerfail_tpu_torch.cli import main

    cfg_file = tmp_path / "cfg.txt"
    cfg_file.write_text(
        "dataset_type = synthetic_box\n"
        "expname = box\n"
        "netdepth = 2\nnetwidth = 64\n"
        "N_samples = 8\nN_importance = 8\nchunk = 256\n"
        "N_rand = 64\nprecrop_iters = 0\ni_weights = 3\n"
    )
    main([
        "train-nerf", "--config", str(cfg_file),
        "--output", str(tmp_path / "out"), "--device", "cpu",
        "--n_iters", "3", "--num_devices", "2", "--model_parallel", "1",
    ])
    assert (tmp_path / "out" / "nerf_logs" / "box" / "000003.ckpt").exists()
