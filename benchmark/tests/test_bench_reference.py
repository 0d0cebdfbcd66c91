"""The plain reference against the port's float32 path at tiny sizes on
the CPU: the same init from a seed, encoding, renderer and Adam."""

import numpy as np
import torch

from benchmark.drivers.nerf_common import program_config
from benchmark.reference import attack as ref_attack
from benchmark.reference import nerf as ref
from benchmark.tests.tiny import SEED, tiny_cell
from nerfail_tpu_torch.models.nerf import apply_nerf
from nerfail_tpu_torch.ops.encoding import positional_encoding
from nerfail_tpu_torch.render import render_rays
from nerfail_tpu_torch.train import nerf_trainer


def _cfg():
    return tiny_cell("nerf_lego_8x256.train").config


def test_init_is_the_programs():
    cfg = _cfg()
    state = nerf_trainer.create_train_state(
        SEED, program_config(cfg).model, program_config(cfg).render,
        program_config(cfg).train, "cpu")
    nets = ref.init_params(SEED, cfg["model"], "cpu")
    for net in ("coarse", "fine"):
        assert list(nets[net]) == list(state.params[net])
        for k, v in nets[net].items():
            assert torch.equal(v, state.params[net][k])


def test_encoding_and_mlp():
    cfg = _cfg()
    m = program_config(cfg).model
    gen = torch.Generator().manual_seed(1)
    x, v = torch.randn(50, 3, generator=gen), torch.randn(50, 3, generator=gen)
    assert torch.allclose(ref.encode(x, 10), positional_encoding(x, 10))
    nets = ref.init_params(SEED, cfg["model"], "cpu")
    want = apply_nerf(nets["coarse"], m, positional_encoding(x, 10),
                      positional_encoding(v, 4))
    got = ref.mlp(nets["coarse"], cfg["model"], x, v)
    assert torch.allclose(got, want, atol=1e-6)


def test_render_rays_train_and_test_paths():
    cfg = _cfg()
    pc = program_config(cfg)
    rc = pc.render.__class__(**{**pc.render.__dict__, "use_pallas": False})
    nets = ref.init_params(SEED, cfg["model"], "cpu")
    gen = torch.Generator().manual_seed(2)
    o = torch.randn(40, 3, generator=gen) * 0.1 + torch.tensor([0., 0., 4.])
    d = torch.randn(40, 3, generator=gen) * 0.2 + torch.tensor([0., 0., -1.])
    t_rand = torch.rand(40, 8, generator=gen)
    u = torch.rand(40, 8, generator=gen)
    for kw in ({"t_rand": t_rand, "u_pdf": u, "train": True}, {}):
        want = render_rays(nets["coarse"], nets["fine"], pc.model, rc, o, d,
                           **kw)
        got = ref.render_rays(nets, cfg["model"], cfg["render"], o, d,
                              kw.get("t_rand"), kw.get("u_pdf"))
        assert torch.allclose(got["rgb"], want["rgb_map"], atol=1e-5)
        assert torch.allclose(got["rgb0"], want["rgb0"], atol=1e-5)
        assert torch.allclose(got["pts_max"], want["pts_max"], atol=1e-5)


def test_adam_is_torchs():
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(20, generator=gen).requires_grad_(True)
    b = a.detach().clone().requires_grad_(True)
    mine, theirs = ref.Adam([a]), torch.optim.Adam([b], lr=1e-3)
    for i in range(4):
        g = torch.randn(20, generator=gen)
        a.grad, b.grad = g.clone(), g.clone()
        mine.step(1e-3)
        theirs.step()
    assert torch.allclose(a, b, atol=1e-7)


def test_fp8_control_rounds():
    gen = torch.Generator().manual_seed(4)
    x, w = torch.randn(64, 32, generator=gen), torch.randn(32, 16,
                                                           generator=gen)
    exact, low = x @ w, ref.fp8_mm(x, w)
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.2
    assert np.isfinite(rel)


def test_grid_knn_is_the_exact_search():
    # points on the faces of a box and a few far off, queries on and off
    # the faces: every neighbour nearer than the last cell size is exact
    gen = torch.Generator().manual_seed(5)
    face = torch.rand(3000, 3, generator=gen) * 1.2 - 0.6
    axis = torch.randint(0, 3, (3000,), generator=gen)
    face[torch.arange(3000), axis] = 0.6 * torch.sign(
        torch.randn(3000, generator=gen))
    far = torch.randn(200, 3, generator=gen) * 3.0
    points = torch.cat([face, far])
    queries = torch.cat([face[:500] + 0.01 * torch.randn(500, 3,
                                                         generator=gen),
                         torch.randn(100, 3, generator=gen)])
    d, i = ref_attack.grid_knn(queries, points, 8)
    dr, ir = ref_attack.knn(queries, points, 8)
    near = dr < ref_attack.CELLS[-1] * (1 - 1e-5)
    assert near.float().mean() > 0.5 and (~near).any()
    assert torch.equal(d[near], dr[near]) and torch.equal(i[near], ir[near])
    assert torch.isinf(d[~near]).all()
