"""PyTorch port, slice 10: scene loaders, writers and classifier datasets
against the JAX package.

Fixtures are written into tmp_path by the JAX package's writers (and, for
DeepVoxels and LINEMOD, by imageio here); both packages then load the same
files. Tolerances: images, poses, splits, focal and intrinsics equal
(both decode the same PNG bytes and run the same numpy); derived poses
(recentred, spherified, render paths) and bounds within 1e-6;
`resize_image` and `load_classifier_split` within 1e-3 on the 0-255 scale
(the port's resize matrices against jax.image.resize).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
imageio = pytest.importorskip("imageio.v2")

H = 16


def _assert_scene_equal(t, j, derived_atol=1e-6):
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_allclose(t.poses, j.poses, atol=derived_atol, rtol=0)
    np.testing.assert_allclose(t.render_poses, j.render_poses,
                               atol=derived_atol, rtol=0)
    assert (t.H, t.W) == (j.H, j.W)
    assert t.focal == j.focal
    if hasattr(j, "K"):
        np.testing.assert_array_equal(t.K, j.K)
    for a, b in zip(t.i_split, j.i_split):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    from nerfail_tpu.data.synthetic import make_box_scene, write_blender_format

    d = str(tmp_path_factory.mktemp("blender"))
    write_blender_format(make_box_scene(n_train=4, n_val=3, n_test=5, H=H,
                                        W=H, seed=2), d)
    return d


@pytest.mark.parametrize("half_res,testskip", [(False, 1), (True, 1),
                                               (False, 2), (True, 0)])
def test_load_blender_data(blender_dir, half_res, testskip):
    from nerfail_tpu.data.blender import load_blender_data as J
    from nerfail_tpu_torch.data.blender import load_blender_data as T

    t = T(blender_dir, half_res=half_res, testskip=testskip)
    j = J(blender_dir, half_res=half_res, testskip=testskip)
    _assert_scene_equal(t, j)
    assert t.images_ori is None and j.images_ori is None


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("half_res", [False, True])
def test_load_blender_train_dir_swap(blender_dir, tmp_path, channels,
                                     half_res):
    """train_dir swaps the train images for r_<i>.png (RGB or RGBA) and
    keeps the originals in images_ori."""
    from nerfail_tpu.data.blender import load_blender_data as J
    from nerfail_tpu_torch.data.blender import load_blender_data as T

    rng = np.random.default_rng(channels)
    for i in range(4):
        imageio.imwrite(str(tmp_path / f"r_{i}.png"), rng.integers(
            0, 256, (H, H, channels)).astype(np.uint8))
    t = T(blender_dir, half_res=half_res, train_dir=str(tmp_path))
    j = J(blender_dir, half_res=half_res, train_dir=str(tmp_path))
    _assert_scene_equal(t, j)
    np.testing.assert_array_equal(t.images_ori, j.images_ori)
    assert not np.array_equal(t.images[t.i_train], t.images_ori)


def test_blender_writer_round_trips_like_jax(tmp_path):
    """The port's writer (utils/png) and the JAX writer (imageio) give
    files that load to the same scene, and the forward scene is
    bit-equal."""
    from nerfail_tpu.data import synthetic as J
    from nerfail_tpu.data.blender import load_blender_data
    from nerfail_tpu_torch.data import synthetic as T

    sc = T.make_box_scene(n_train=3, n_val=1, n_test=2, H=H, W=H, seed=5)
    T.write_blender_format(sc, str(tmp_path / "t"))
    J.write_blender_format(J.make_box_scene(n_train=3, n_val=1, n_test=2,
                                            H=H, W=H, seed=5),
                           str(tmp_path / "j"))
    _assert_scene_equal(load_blender_data(str(tmp_path / "t")),
                        load_blender_data(str(tmp_path / "j")))
    kw = dict(n_train=3, n_val=1, n_test=2, H=H, W=H, seed=1)
    ft, fj = T.make_forward_scene(**kw), J.make_forward_scene(**kw)
    _assert_scene_equal(ft, fj, derived_atol=0)


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    from nerfail_tpu.data.synthetic import make_forward_scene, write_llff_format

    d = str(tmp_path_factory.mktemp("llff"))
    write_llff_format(make_forward_scene(n_train=8, n_val=1, n_test=3, H=32,
                                         W=32, seed=3), d)
    return d


@pytest.mark.parametrize("kw", [
    dict(factor=2), dict(factor=2, spherify=True), dict(factor=1),
    dict(height=8), dict(width=16, path_zflat=True),
    dict(factor=4, recenter=False, bd_factor=None),
])
def test_load_llff_data(llff_dir, kw):
    from nerfail_tpu.data.llff import load_llff_data as J
    from nerfail_tpu_torch.data.llff import load_llff_data as T

    t, j = T(llff_dir, **kw), J(llff_dir, **kw)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_allclose(t.poses, j.poses, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.render_poses, j.render_poses, atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(t.bds, j.bds, atol=1e-6, rtol=0)
    assert (t.i_test, t.H, t.W, t.focal) == (j.i_test, j.H, j.W, j.focal)


def test_llff_writer_round_trips_like_jax(tmp_path):
    from nerfail_tpu.data.llff import load_llff_data
    from nerfail_tpu.data.synthetic import make_forward_scene as jf
    from nerfail_tpu.data.synthetic import write_llff_format as jw
    from nerfail_tpu_torch.data.synthetic import make_forward_scene as tf
    from nerfail_tpu_torch.data.synthetic import write_llff_format as tw

    kw = dict(n_train=4, n_val=1, n_test=1, H=H, W=H, seed=4)
    tw(tf(**kw), str(tmp_path / "t"))
    jw(jf(**kw), str(tmp_path / "j"))
    t = load_llff_data(str(tmp_path / "t"), factor=1)
    j = load_llff_data(str(tmp_path / "j"), factor=1)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.poses, j.poses)


def _write_dv(basedir, counts=(4, 3, 5)):
    rng = np.random.default_rng(0)
    for mode, n in zip(["train", "validation", "test"], counts):
        d = os.path.join(basedir, mode, "cube")
        os.makedirs(os.path.join(d, "rgb"))
        os.makedirs(os.path.join(d, "pose"))
        with open(os.path.join(d, "intrinsics.txt"), "w") as f:
            f.write(f"64.0 {H / 2} {H / 2} 0.\n1.0\n1.0\n32.0\n")
        for i in range(n):
            imageio.imwrite(os.path.join(d, "rgb", f"{i:04d}.png"),
                            rng.integers(0, 256, (H, H, 3)).astype(np.uint8))
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = rng.uniform(-2, 2, 3)
            np.savetxt(os.path.join(d, "pose", f"{i:04d}.txt"),
                       pose.reshape(-1)[None])


@pytest.mark.parametrize("testskip", [1, 2])
def test_load_dv_data(tmp_path, testskip):
    from nerfail_tpu.data.deepvoxels import load_dv_data as J
    from nerfail_tpu_torch.data.deepvoxels import load_dv_data as T

    _write_dv(str(tmp_path))
    kw = dict(scene="cube", basedir=str(tmp_path), testskip=testskip)
    _assert_scene_equal(T(**kw), J(**kw))


def _write_linemod(basedir, with_K=True, counts=(4, 3, 5)):
    rng = np.random.default_rng(1)
    K = np.array([[70.0, 0, 7.5], [0, 70.0, 8.5], [0, 0, 1]], np.float32)
    for split, n in zip(["train", "val", "test"], counts):
        os.makedirs(os.path.join(basedir, split), exist_ok=True)
        frames = []
        for i in range(n):
            rel = f"{split}/r_{i}.png"
            imageio.imwrite(os.path.join(basedir, rel),
                            rng.integers(0, 256, (H, H, 4)).astype(np.uint8))
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = rng.uniform(-2, 2, 3)
            fr = {"file_path": rel, "transform_matrix": pose.tolist()}
            if with_K:
                fr["intrinsic_matrix"] = K.tolist()
            frames.append(fr)
        with open(os.path.join(basedir, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames, "near": 0.4, "far": 1.8,
                       "camera_angle_x": 0.7}, f)


@pytest.mark.parametrize("with_K,half_res,testskip", [
    (True, False, 2), (False, True, 1)])
def test_load_linemod_data(tmp_path, with_K, half_res, testskip):
    from nerfail_tpu.data.linemod import load_LINEMOD_data as J
    from nerfail_tpu_torch.data.linemod import load_LINEMOD_data as T

    _write_linemod(str(tmp_path), with_K=with_K)
    t = T(str(tmp_path), half_res=half_res, testskip=testskip)
    j = J(str(tmp_path), half_res=half_res, testskip=testskip)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.poses, j.poses)
    np.testing.assert_array_equal(t.K, j.K)
    assert (t.H, t.W, t.near, t.far) == (j.H, j.W, j.near, j.far)
    for a, b in zip(t.i_split, j.i_split):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset_type,extra", [
    ("blender", {"half_res": True}),
    ("synthetic_box", {}),
    ("llff", {"factor": 2}),
    ("llff", {"factor": 2, "no_ndc": True, "llffhold": 0}),
    ("llff", {"factor": 2, "spherify": True}),
    ("deepvoxels", {"testskip": 2}),
    ("LINEMOD", {"testskip": 1}),
])
def test_load_scene(tmp_path, blender_dir, llff_dir, dataset_type, extra):
    """load_scene resolves the same scene and render geometry (ndc, near,
    far, white_bkgd) for every dataset type."""
    from nerfail_tpu.config import ExperimentConfig as JC
    from nerfail_tpu.config import SceneConfig as JS
    from nerfail_tpu.data.load import load_scene as J
    from nerfail_tpu_torch.config import ExperimentConfig as TC
    from nerfail_tpu_torch.config import SceneConfig as TS
    from nerfail_tpu_torch.data.load import load_scene as T

    datadir = {"blender": blender_dir, "llff": llff_dir}.get(
        dataset_type, str(tmp_path))
    if dataset_type == "deepvoxels":
        _write_dv(str(tmp_path))
    if dataset_type == "LINEMOD":
        _write_linemod(str(tmp_path))
    sc = dict(datadir=datadir, dataset_type=dataset_type, expname="cube",
              **extra)
    t, tcfg = T(TC(scene=TS(**sc)))
    j, jcfg = J(JC(scene=JS(**sc)))
    _assert_scene_equal(t, j)
    assert dataclasses.asdict(tcfg.render) == dataclasses.asdict(jcfg.render)


def test_mask_views_and_class_index():
    from nerfail_tpu import config as J
    from nerfail_tpu_torch import config as T

    for p in (2, 3, 4):
        for scene in J.SCENE_CLASSES:
            assert T.mask_views(scene, p) == J.mask_views(scene, p)
    for scene in J.SCENE_CLASSES:
        assert T.scene_class_index(scene) == J.scene_class_index(scene)


@pytest.mark.parametrize("size", [None, 16, 10, 27])
def test_resize_image(size):
    from nerfail_tpu.data.datasets import resize_image as J
    from nerfail_tpu_torch.data.datasets import resize_image as T

    img = np.random.default_rng(0).uniform(0, 255, (16, 16, 3)).astype(
        np.float32)
    t, j = T(img, size), J(img, size)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def class_root(tmp_path_factory):
    """An 8-class root of box renders (data/<class>/{train,val,test})."""
    from nerfail_tpu.config import SCENE_CLASSES
    from nerfail_tpu.data.synthetic import make_box_scene, write_blender_format

    root = str(tmp_path_factory.mktemp("classes"))
    for ci, cls in enumerate(SCENE_CLASSES):
        write_blender_format(make_box_scene(n_train=2, n_val=1, n_test=3,
                                            H=H, W=H, seed=ci, variant=ci),
                             os.path.join(root, cls))
    return root


@pytest.mark.parametrize("split,size", [("train", None), ("val", 12),
                                        ("test", 20)])
def test_load_classifier_split(class_root, split, size):
    from nerfail_tpu.data.datasets import load_classifier_split as J
    from nerfail_tpu_torch.data.datasets import load_classifier_split as T

    t, j = T(class_root, split, size), J(class_root, split, size)
    np.testing.assert_allclose(t.images, j.images, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.indices, j.indices)
    assert t.ori_images is None and j.ori_images is None


def test_load_classifier_split_override(class_root, tmp_path):
    """One class's images come from an attacked dir (r_<i>.png, skipping
    _ori and mask files), its originals from ori_dir."""
    from nerfail_tpu.data.datasets import load_classifier_split as J
    from nerfail_tpu_torch.data.datasets import load_classifier_split as T

    rng = np.random.default_rng(3)
    att = tmp_path / "att"
    att.mkdir()
    for i in (0, 2, 10):
        imageio.imwrite(str(att / f"r_{i}.png"),
                        rng.integers(0, 256, (H, H, 4)).astype(np.uint8))
        imageio.imwrite(str(att / f"r_{i}_ori.png"),
                        rng.integers(0, 256, (H, H, 4)).astype(np.uint8))
    imageio.imwrite(str(att / "mask_0.png"),
                    np.zeros((H, H, 4), np.uint8))
    kw = dict(override_dir=str(att), override_class="lego",
              ori_dir=str(att))
    for size in (None, 12):
        # the originals come from ori_dir's r_<i>.png: here the attacked
        # dir itself, so the ori files must also exist there
        t = T(class_root, "test", size, **kw)
        j = J(class_root, "test", size, **kw)
        np.testing.assert_allclose(t.images, j.images, atol=1e-3, rtol=0)
        np.testing.assert_allclose(t.ori_images, j.ori_images, atol=1e-3,
                                   rtol=0)
        np.testing.assert_array_equal(t.labels, j.labels)
        np.testing.assert_array_equal(t.indices, j.indices)


def test_list_split_images_grammar(tmp_path):
    from nerfail_tpu.data.datasets import list_split_images as J
    from nerfail_tpu_torch.data.datasets import list_split_images as T

    d = tmp_path / "c" / "test"
    d.mkdir(parents=True)
    for name in ("r_3.png", "r_10.png", "002.png", "007.jpg", "r_1_ori.png",
                 "notes.txt", "r_x.png"):
        (d / name).write_bytes(b"")
    assert T(str(tmp_path / "c"), "test") == J(str(tmp_path / "c"), "test")
    assert T(str(tmp_path / "c"), "val") == []


def test_white_rgb_and_scene_views():
    from nerfail_tpu.data import datasets as J
    from nerfail_tpu_torch.data import datasets as T

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 5, 5, 4)).astype(np.float32)
    img[..., 3] *= rng.integers(0, 2, (2, 5, 5))
    np.testing.assert_array_equal(T.rgba_to_white_rgb(img),
                                  J.rgba_to_white_rgb(img))
    np.testing.assert_array_equal(T.rgba_to_white_rgb(img[..., :3]),
                                  img[..., :3])
    x = rng.uniform(-0.2, 1.2, (2, 5, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(T.scene_views_dataset(x),
                                  J.scene_views_dataset(x))
