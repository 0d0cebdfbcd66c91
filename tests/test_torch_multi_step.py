"""PyTorch port, slice 11: `make_multi_train_step`, k NeRF train steps per
call, on the CPU (the same k-step program the card captures as one CUDA
graph; tests/test_torch_gpu.py holds the captured window on the card).

The port's window is held to the JAX package's through a chain of
same-input checks, since the JAX window draws its rays inside the
`lax.scan` from fold_in(base_key, i) and the port's from torch
generators, so the two windows cannot be fed the same rays:
  * JAX window = JAX single steps on the same data (the JAX case of
    `test_k_multi_steps_equal_k_single_steps`, as
    tests/test_aux.py::TestMultiTrainStep);
  * JAX single step = the port's single step on the same rays and
    uniforms (tests/test_torch_nerf_trainer.py::test_train_step_matches_jax);
  * the port's single steps = the port's window on the same (seed, i)
    draws (the torch cases below).
Tolerances:
  * k multi-steps against k `make_train_step` steps on the same draws, in
    either package: parameters at rtol/atol 1e-6, loss at rtol 1e-6 (the
    same ops in the same order; the port's window zeroes gradients in
    place where the single step sets them to None, which can only flip
    the sign of a zero; the JAX bound is test_aux.py's);
  * a window started at step s against steps s…s+k-1 of an unbroken run:
    the same bound;
  * the learning rate: `lr_tensor` (float64 on the device, rounded to
    float32) against `lr_at` and optax's schedule at rtol 1e-6 (float32
    rounding is 6·10⁻⁸).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from nerfail_tpu_torch.config import (  # noqa: E402
    NeRFModelConfig, RenderConfig, TrainConfig,
)
from nerfail_tpu_torch.train.nerf_trainer import (  # noqa: E402
    create_train_state, lr_at, lr_tensor, make_capturable,
    make_multi_train_step, make_train_step, sample_rays, step_seed,
)

H = W = 8
TOL = dict(rtol=1e-6, atol=1e-6)
# (N_importance, use_pallas): the unfused coarse path as test_aux.py's,
# and coarse + fine through the fused MLP's plain versions (K4/K5's)
CASES = {"coarse_unfused": (0, False), "fine_fused": (4, True)}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _setup(case):
    n_imp, fused = CASES[case]
    mcfg = NeRFModelConfig(netdepth=2, netwidth=32, multires=2,
                           multires_views=2, skips=(0,))
    rcfg = RenderConfig(N_samples=4, N_importance=n_imp, chunk=64,
                        use_pallas=fused)
    tcfg = TrainConfig(N_rand=16, precrop_iters=0)
    images = torch.linspace(0, 1, 2 * H * W * 3).reshape(2, H, W, 3)
    poses = torch.eye(4).expand(2, 4, 4).clone()
    poses[:, 2, 3] = 4.0
    poses[1, 0, 3] = 0.5
    K = torch.tensor([[5.0, 0, 4], [0, 5.0, 4], [0, 0, 1]])
    return mcfg, rcfg, tcfg, images, poses, K


def _single_steps(mcfg, rcfg, tcfg, images, poses, K, seed, steps):
    """`steps` make_train_step steps from a fresh state, step i drawing
    from a generator seeded as train_nerf seeds it."""
    state = create_train_state(0, mcfg, rcfg, tcfg, "cpu")
    step = make_train_step(mcfg, rcfg, tcfg)
    metrics = None
    for i in range(steps):
        gen = torch.Generator().manual_seed(step_seed(seed, i))
        batch = sample_rays(gen, images, poses, K, tcfg.N_rand, False,
                            tcfg.precrop_frac, tcfg.no_batching)
        metrics = step(state, batch, gen, (H, W), float(K[0, 0]))
    return state, metrics


def _assert_params_close(a, b):
    for net in ("coarse", "fine"):
        for k in a.params[net]:
            np.testing.assert_allclose(
                a.params[net][k].detach().numpy(),
                b.params[net][k].detach().numpy(), err_msg=f"{net}/{k}",
                **TOL)


def _jax_multi_vs_single(case):
    """The JAX package's window of k = 3 against three of its single steps
    on _setup's data, step i keyed by fold_in(base, i) (its plain MLP:
    the fused kernel runs only on the TPU)."""
    import jax.numpy as jnp

    from nerfail_tpu.config import (
        NeRFModelConfig as JM, RenderConfig as JR, TrainConfig as JT,
    )
    from nerfail_tpu.train.nerf_trainer import (
        create_train_state as j_state, make_multi_train_step as j_multi,
        make_train_step as j_step,
    )

    n_imp, _ = CASES[case]
    mcfg = JM(netdepth=2, netwidth=32, multires=2, multires_views=2,
              skips=(0,))
    rcfg = JR(N_samples=4, N_importance=n_imp, chunk=64, use_pallas=False)
    tcfg = JT(N_rand=16, precrop_iters=0)
    images, poses, K = (jnp.asarray(x.numpy()) for x in _setup(case)[3:])
    state = j_state(jax.random.PRNGKey(0), mcfg, rcfg, tcfg)
    base = jax.random.PRNGKey(7)
    step = j_step(mcfg, rcfg, tcfg, precrop=False)
    p, o = state.params, state.opt_state
    for i in range(3):
        p, o, m_ref = step(p, o, images, poses, K,
                           jax.random.fold_in(base, i))
    p2, _, m = j_multi(mcfg, rcfg, tcfg, precrop=False, k=3)(
        state.params, state.opt_state, images, poses, K, base)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), **TOL), p, p2)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["psnr"]), float(m_ref["psnr"]),
                               rtol=1e-6)


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_k_multi_steps_equal_k_single_steps(case, package):
    if package == "jax":
        _jax_multi_vs_single(case)
        return
    mcfg, rcfg, tcfg, images, poses, K = _setup(case)
    ref, m_ref = _single_steps(mcfg, rcfg, tcfg, images, poses, K, 7, 3)
    state = create_train_state(0, mcfg, rcfg, tcfg, "cpu")
    multi = make_multi_train_step(mcfg, rcfg, tcfg, precrop=False, k=3)
    m = multi(state, images, poses, K, 7)
    assert state.step == 3
    _assert_params_close(ref, state)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["psnr"]), float(m_ref["psnr"]),
                               rtol=1e-6)
    for p_ref, p in zip(ref.opt_state.state.values(),
                        state.opt_state.state.values()):
        np.testing.assert_allclose(p["exp_avg_sq"].numpy(),
                                   p_ref["exp_avg_sq"].numpy(), **TOL)
        assert float(p["step"]) == float(p_ref["step"]) == 3.0


def test_window_started_at_s_equals_the_unbroken_run():
    """Two single steps, then a window of k = 2 from step 2, equal four
    single steps: the window draws steps 2 and 3's streams."""
    mcfg, rcfg, tcfg, images, poses, K = _setup("fine_fused")
    ref, m_ref = _single_steps(mcfg, rcfg, tcfg, images, poses, K, 3, 4)
    state = create_train_state(0, mcfg, rcfg, tcfg, "cpu")
    step = make_train_step(mcfg, rcfg, tcfg)
    for i in range(2):
        gen = torch.Generator().manual_seed(step_seed(3, i))
        batch = sample_rays(gen, images, poses, K, tcfg.N_rand, False,
                            tcfg.precrop_frac, tcfg.no_batching)
        step(state, batch, gen, (H, W), float(K[0, 0]))
    multi = make_multi_train_step(mcfg, rcfg, tcfg, precrop=False, k=2)
    m = multi(state, images, poses, K, 3)
    assert state.step == 4
    _assert_params_close(ref, state)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-6)


def test_precrop_window_draws_inside_the_crop():
    """A window made with precrop=True draws what precropped single steps
    draw: the same parameters after k = 2."""
    mcfg, rcfg, tcfg, images, poses, K = _setup("coarse_unfused")
    state = create_train_state(0, mcfg, rcfg, tcfg, "cpu")
    step = make_train_step(mcfg, rcfg, tcfg)
    for i in range(2):
        gen = torch.Generator().manual_seed(step_seed(5, i))
        batch = sample_rays(gen, images, poses, K, tcfg.N_rand, True,
                            tcfg.precrop_frac, tcfg.no_batching)
        step(state, batch, gen, (H, W), float(K[0, 0]))
    other = create_train_state(0, mcfg, rcfg, tcfg, "cpu")
    make_multi_train_step(mcfg, rcfg, tcfg, precrop=True, k=2)(
        other, images, poses, K, 5)
    _assert_params_close(state, other)


def test_device_schedule_gives_lr_at_each_step():
    """The schedule the captured window computes from its device step
    counter, and the rates a CPU window sets, against lr_at and the optax
    schedule the JAX package's make_optimizer builds."""
    import optax

    tcfg = TrainConfig(lrate=5e-4, lrate_decay=250)
    sched = optax.exponential_decay(5e-4, transition_steps=250 * 1000,
                                    decay_rate=0.1)
    for s in (0, 1, 2, 999, 125_000, 250_000, 600_000):
        got = lr_tensor(tcfg, torch.tensor(float(s), dtype=torch.float64))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), lr_at(tcfg, s), rtol=1e-6)
        np.testing.assert_allclose(float(got), float(sched(s)), rtol=1e-6)

    # a CPU window sets lr_at(step) before each of its updates
    mcfg, rcfg, _, images, poses, K = _setup("coarse_unfused")
    tcfg = TrainConfig(N_rand=16, precrop_iters=0, lrate=5e-4, lrate_decay=1)
    state = create_train_state(0, mcfg, rcfg, tcfg, "cpu")
    state.step = 500
    seen = []
    orig = state.opt_state.step

    def spy(*a, **kw):
        seen.append(state.opt_state.param_groups[0]["lr"])
        return orig(*a, **kw)

    state.opt_state.step = spy
    make_multi_train_step(mcfg, rcfg, tcfg, precrop=False, k=3)(
        state, images, poses, K, 0)
    np.testing.assert_allclose(seen, [lr_at(tcfg, s) for s in (500, 501, 502)],
                               rtol=1e-12)


def test_the_eager_optimizer_stays_plain():
    """make_optimizer builds the plain Adam with a float learning rate
    (the capturable one is a captured window's, made on the card by
    make_capturable, which refuses parameters elsewhere)."""
    mcfg, rcfg, tcfg, *_ = _setup("coarse_unfused")
    state = create_train_state(0, mcfg, rcfg, tcfg, "cpu")
    group = state.opt_state.param_groups[0]
    assert not group["capturable"] and group["lr"] == tcfg.lrate
    with pytest.raises(ValueError, match="on the card"):
        make_capturable(state.opt_state)
