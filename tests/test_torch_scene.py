"""PyTorch port, slice 1: scene fixtures, import hygiene, default device.

The scene generator is host numpy in both packages, so poses, shaded
images and analytic coordinate maps must be bit-equal (no tolerance).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("theta,phi,radius", [(30.0, -40.0, 4.0),
                                              (-121.5, -12.0, 3.2)])
def test_poses_bit_equal(theta, phi, radius):
    from nerfail_tpu.data.poses import pose_spherical as jp
    from nerfail_tpu.data.poses import render_spiral_poses as jr
    from nerfail_tpu_torch.data.poses import pose_spherical as tp
    from nerfail_tpu_torch.data.poses import render_spiral_poses as tr

    np.testing.assert_array_equal(tp(theta, phi, radius),
                                  jp(theta, phi, radius))
    np.testing.assert_array_equal(tr(7, phi, radius), jr(7, phi, radius))


def test_box_scene_bit_equal_at_64():
    from nerfail_tpu.data import synthetic as J
    from nerfail_tpu_torch.data import synthetic as T

    kw = dict(n_train=3, n_val=1, n_test=1, H=64, W=64, seed=3, variant=2)
    sj, st = J.make_box_scene(**kw), T.make_box_scene(**kw)
    np.testing.assert_array_equal(st.images, sj.images)
    np.testing.assert_array_equal(st.poses, sj.poses)
    np.testing.assert_array_equal(st.render_poses, sj.render_poses)
    np.testing.assert_array_equal(st.K, sj.K)
    assert st.focal == sj.focal
    for a, b in zip(st.i_split, sj.i_split):
        np.testing.assert_array_equal(a, b)


def test_coord_map_and_shade_bit_equal_at_64():
    from nerfail_tpu.data import synthetic as J
    from nerfail_tpu.ops.rays import get_rays_np as j_rays
    from nerfail_tpu_torch.data import synthetic as T
    from nerfail_tpu_torch.ops.rays import get_rays_np as t_rays

    scene = J.make_box_scene(n_train=4, n_val=0, n_test=0, H=64, W=64)
    for v in range(4):
        pose = scene.poses[v]
        np.testing.assert_array_equal(
            T.analytic_coord_map(pose, 64, 64, scene.K),
            J.analytic_coord_map(pose, 64, 64, scene.K),
        )
        o, d = t_rays(64, 64, scene.K, pose)
        oj, dj = j_rays(64, 64, scene.K, pose)
        np.testing.assert_array_equal(o, oj)
        np.testing.assert_array_equal(d, dj)
        for variant in (0, 5):
            np.testing.assert_array_equal(
                T._shade(o.reshape(-1, 3), d.reshape(-1, 3), variant),
                J._shade(o.reshape(-1, 3), d.reshape(-1, 3), variant),
            )


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerfail_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'nerfail_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nerfail_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20     # every module was imported


def _tiny_attack_inputs():
    rng = np.random.default_rng(0)
    delta0 = np.zeros((1, 4, 4, 4), np.float32)
    w = rng.uniform(0, 1, (2, 4, 4, 8)).astype(np.float32)
    idx = rng.integers(0, 16, (2, 4, 4, 8)).astype(np.int32)
    ori = rng.uniform(0, 255, (2, 4, 4, 4)).astype(np.float32)
    return delta0, w, idx, ori


def _entry_points():
    from nerfail_tpu_torch.attacks.forward import splat_attack_forward
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.eval.harness import evaluate_attack
    from nerfail_tpu_torch.ops.cuda.knn_kernel import KnnPrep, knn
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist

    delta0, w, idx, ori = _tiny_attack_inputs()
    pts = np.random.default_rng(1).uniform(-1, 1, (64, 3)).astype(np.float32)
    logits = lambda x: x.reshape(x.shape[0], -1)[:, :8]
    return {
        "nerfail_s_attack": lambda: nerfail_s_attack(
            delta0, w, idx, ori, np.zeros(2), logits, AttackConfig(),
            resize_to=None, epochs=1),
        "splat_attack_forward": lambda: splat_attack_forward(
            delta0.reshape(-1, 4), w, idx, ori, logits, resize_to=None),
        "build_index_and_dist": lambda: build_index_and_dist(
            pts[:16].reshape(4, 4, 3), pts),
        "knn": lambda: knn(pts[:16], pts),
        "KnnPrep": lambda: KnnPrep(pts),
        "evaluate_attack": lambda: evaluate_attack(
            logits, ori[..., :3], ori[..., :3], true_label=0),
    }


@pytest.mark.parametrize("name", ["nerfail_s_attack", "splat_attack_forward",
                                  "build_index_and_dist", "knn", "KnnPrep",
                                  "evaluate_attack"])
def test_entry_points_default_to_the_card(name):
    """Without a card, the default device raises instead of falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
