"""PyTorch port, slice 10 as a whole: ArtifactLayout, save_attacked_images,
Pipeline's stages and the CLI against the JAX package, on the CPU.

Tolerances:
  - ArtifactLayout paths and save_attacked_images file names: equal;
    written images decode to equal bytes;
  - stage_attack, each method at 16² on the same tables, views and
    linear classifier, three epochs: the stage_eval reports agree on the
    ASR, both accuracies and the misclassification histogram exactly and
    on the perturbation stats within 2 % (sign ties in the sign-step
    engines, DeepFool near-ties in the others: ROADMAP Queue 3);
  - stage_eval_full on the same files: equal counts, losses within 1e-4;
  - stage_inherit and cli.main run end to end at 16² with
    `--device cpu` and leave every artifact the reference grammar names.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.config import AttackConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 16
METHODS = ["NeRFail", "NeRFail_S", "IGSM_2D", "Universal_2D"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _acfgs():
    from nerfail_tpu.config import AttackConfig as JA

    grid = itertools.product([32.0, 8.5], [2.0, 0.5], [8.0, 3.0],
                             [100.0, 1000.0], [False, True], [3, 2])
    for eps, a, m1, m2, targeted, p in grid:
        kw = dict(eps=eps, a=a, m1=m1, m2=m2, targeted=targeted,
                  target_label=5, base_mask_number=p, attack_epochs=100)
        yield AttackConfig(**kw), JA(**kw)


def test_artifact_layout_matches_jax():
    from nerfail_tpu.pipeline import ArtifactLayout as J
    from nerfail_tpu_torch.pipeline import ArtifactLayout as T

    t, j = T("/out"), J("/out")
    for scene in ("lego", "ship"):
        assert t.nerf_logdir(scene) == j.nerf_logdir(scene)
        assert t.nerf_logdir(scene, "tag") == j.nerf_logdir(scene, "tag")
        assert t.coords_dir(scene) == j.coords_dir(scene)
        for p, split in itertools.product((2, 3), ("train", "test", "val")):
            assert t.tables_path(scene, p, split) == \
                j.tables_path(scene, p, split)
    assert t.classifier_dir("inception") == j.classifier_dir("inception")
    assert t.classifier_best("vgg16") == j.classifier_best("vgg16")
    n = 0
    for ta, ja in _acfgs():
        for method in METHODS + ["No_attack"]:
            assert t.attack_method_dirname(method, ta) == \
                j.attack_method_dirname(method, ja)
            assert t.attack_method_dirname(method, ta, target=3) == \
                j.attack_method_dirname(method, ja, target=3)
            for step, split in itertools.product(
                    range(4), (None, "test", "train", "val")):
                d = t.attack_dir("inception", "lego", method, ta, step, split)
                assert d == j.attack_dir("inception", "lego", method, ja,
                                         step, split)
                n += 1
        assert t.attack_masks_dir("/x", "test") == \
            j.attack_masks_dir("/x", "test")
        assert t.eval_report_path("/x", "val") == \
            j.eval_report_path("/x", "val")
    assert n == 64 * 5 * 16
    with pytest.raises(ValueError):
        t.attack_method_dirname("FGSM", AttackConfig())


def _listing(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


@pytest.mark.parametrize("with_masks,indices", [(True, None),
                                                (False, [4, 7, 12])])
def test_save_attacked_images_matches_jax(tmp_path, with_masks, indices):
    from nerfail_tpu.pipeline import save_attacked_images as J
    from nerfail_tpu_torch.pipeline import save_attacked_images as T
    from nerfail_tpu_torch.utils.png import imread

    rng = np.random.default_rng(0)
    att = rng.uniform(-20, 280, (3, H, H, 4)).astype(np.float32)
    masks = rng.uniform(-20, 280, (3, H, H, 4)).astype(np.float32)
    ori = rng.uniform(0, 255, (3, H, H, 4)).astype(np.float32)
    kw = dict(masks=masks if with_masks else None, originals=ori,
              indices=indices)
    T(str(tmp_path / "t" / "m" / "test"), att, **kw)
    J(str(tmp_path / "j" / "m" / "test"), att, **kw)
    names = _listing(tmp_path / "t")
    assert names == _listing(tmp_path / "j")
    assert len(names) == 3 * (3 if with_masks else 2)
    for name in names:
        np.testing.assert_array_equal(imread(str(tmp_path / "t" / name)),
                                      imread(str(tmp_path / "j" / name)))


@pytest.fixture(scope="module")
def world():
    """A 16² box scene: 4 test views attacked through tables from 2 mask
    views, and a linear classifier on the flattened 16² RGB view, the same
    numpy weights in both packages (sensitive enough that every engine
    flips views within a few epochs)."""
    from nerfail_tpu.config import SCENE_CLASSES
    from nerfail_tpu.data.synthetic import analytic_coord_map, make_box_scene
    from nerfail_tpu.pointset.knn_build import knn_host_tree
    from nerfail_tpu.pointset.weights import gauss_weights

    sc = make_box_scene(n_train=4, n_val=0, n_test=0, H=H, W=H, seed=11)
    ori = (sc.images * 255.0).astype(np.float32)
    mask = [0, 2]
    S = np.concatenate([analytic_coord_map(sc.poses[v], H, H, sc.K)
                        .reshape(-1, 3) for v in mask])
    w, i = [], []
    for v in range(4):
        d, ix = knn_host_tree(
            analytic_coord_map(sc.poses[v], H, H, sc.K).reshape(-1, 3), S)
        w.append(np.asarray(gauss_weights(jnp.asarray(d), c=1.0))
                 .reshape(H, H, 8))
        i.append(ix.reshape(H, H, 8))
    wm = np.random.default_rng(3).normal(0, 1e-3, (H * H * 3, 8)).astype(
        np.float32)

    def j_logits(x):
        return x.reshape(x.shape[0], -1) @ jnp.asarray(wm)

    def t_logits(x):
        return x.reshape(x.shape[0], -1) @ torch.from_numpy(wm).to(x.device)

    # the attacked scene is the class the net gives most clean views, so
    # that clean accuracy and ASR are not trivially 0 and 1
    clean = np.where(ori[..., 3:] > 0, ori[..., :3], 255.0)
    preds = np.argmax(np.asarray(j_logits(jnp.asarray(clean))), -1)
    return dict(ori=ori, tables=(np.stack(w), np.stack(i)),
                scene=SCENE_CLASSES[int(np.bincount(preds).argmax())],
                mask_images=ori[mask], j_logits=j_logits, t_logits=t_logits)


@pytest.mark.parametrize("method", METHODS)
def test_stage_attack_matches_jax(world, tmp_path, method):
    from nerfail_tpu.config import AttackConfig as JA
    from nerfail_tpu.config import ExperimentConfig as JE
    from nerfail_tpu.pipeline import ArtifactLayout as JL
    from nerfail_tpu.pipeline import Pipeline as JP
    from nerfail_tpu_torch.config import ExperimentConfig
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline

    kw = dict(method=method, eps=16.0, a=4.0, m1=1.0, m2=2.0,
              attack_epochs=3, df_max_iter=30, overshoot=0.2, batch_size=2,
              view_batch=2)
    scene = world["scene"]
    args = dict(scene_name=scene, model_name="simple_cnn", resize_to=None,
                ori_images=world["ori"], tables=world["tables"],
                mask_images=world["mask_images"], epochs=3)
    reports = {}
    for tag, P, L, E, A, logits in (
            ("t", Pipeline, ArtifactLayout, ExperimentConfig, AttackConfig,
             world["t_logits"]),
            ("j", JP, JL, JE, JA, world["j_logits"])):
        extra = {"device": "cpu"} if tag == "t" else {}
        pipe = P(L(str(tmp_path / tag)), E(), **extra)
        acfg = A(**kw)
        res = pipe.stage_attack(method, acfg, logits_fn=logits, **args)
        attacked, _ = pipe.render_attacked(method, res.delta, world["ori"],
                                           world["tables"], acfg, None,
                                           logits)
        reports[tag] = pipe.stage_eval(logits, attacked, world["ori"],
                                       scene)
        method_dir = pipe.layout.attack_dir("simple_cnn", scene, method,
                                            acfg)
        assert not os.path.exists(os.path.join(method_dir,
                                                "attack_state.npz"))
    assert _listing(tmp_path / "t") == _listing(tmp_path / "j")
    t, j = reports["t"], reports["j"]
    assert t.keys() == j.keys()
    for k in ("asr", "clean_acc_target_class", "attacked_acc_target_class",
              "misclass_histogram"):
        assert t[k] == j[k], k
    for k, v in j.items():
        if isinstance(v, float) and np.isfinite(v):
            np.testing.assert_allclose(t[k], v, rtol=0.02, atol=1e-6,
                                       err_msg=k)
    assert t["e_max"] <= 16.0 + 1e-3


def test_stage_eval_full_matches_jax(world, tmp_path):
    from nerfail_tpu.config import ExperimentConfig as JE
    from nerfail_tpu.config import SCENE_CLASSES
    from nerfail_tpu.data.synthetic import make_box_scene, write_blender_format
    from nerfail_tpu.pipeline import ArtifactLayout as JL
    from nerfail_tpu.pipeline import Pipeline as JP
    from nerfail_tpu.pipeline import save_attacked_images
    from nerfail_tpu_torch.config import ExperimentConfig
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline

    root = str(tmp_path / "data")
    for ci, cls in enumerate(SCENE_CLASSES):
        write_blender_format(make_box_scene(n_train=1, n_val=1, n_test=2,
                                            H=H, W=H, seed=ci, variant=ci),
                             os.path.join(root, cls))
    att_dir = str(tmp_path / "att")
    rng = np.random.default_rng(0)
    att = np.clip(world["ori"] + rng.uniform(-30, 30, world["ori"].shape),
                  0, 255)
    save_attacked_images(att_dir, att, originals=world["ori"])
    kw = dict(override_dir=att_dir, ori_dir=None, resize_to=None)
    t = Pipeline(ArtifactLayout(str(tmp_path)), ExperimentConfig(),
                 device="cpu").stage_eval_full(world["t_logits"], root,
                                               "test", "ship", **kw)
    j = JP(JL(str(tmp_path)), JE()).stage_eval_full(
        world["j_logits"], root, "test", "ship", **kw)
    assert t["per_class"].keys() == j["per_class"].keys()
    for c, v in j["per_class"].items():
        assert t["per_class"][c]["n"] == v["n"]
        np.testing.assert_allclose(t["per_class"][c]["loss"], v["loss"],
                                   rtol=1e-4)
    for k in ("asr", "misclass_histogram", "misclass_to_pct"):
        assert t[k] == j[k], k


def test_stage_pointset_matches_jax(tmp_path):
    """Coordinate maps of one NeRF (JAX init carried over) for the mask
    views and every split, the point set and the 8-NN tables: S within
    1e-4 (the renders' f32 parity), indices equal on ≥ 99 % of the entries
    (distance ties and JAX's |q|²+|p|²−2q·p on the CPU, ROADMAP Queue 3)
    and weights within 1e-3 where the indices agree; a second call reads
    the saved tables back."""
    from nerfail_tpu.config import ExperimentConfig as JE
    from nerfail_tpu.config import NeRFModelConfig as JM
    from nerfail_tpu.config import RenderConfig as JR
    from nerfail_tpu.data.synthetic import make_box_scene
    from nerfail_tpu.models.nerf import init_nerf_params
    from nerfail_tpu.pipeline import ArtifactLayout as JL
    from nerfail_tpu.pipeline import Pipeline as JP
    from nerfail_tpu_torch.config import (
        ExperimentConfig, NeRFModelConfig, RenderConfig,
    )
    from nerfail_tpu_torch.models.nerf import nerf_params_from_jax
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline

    model = dict(netdepth=2, netwidth=32, multires=4, multires_views=2)
    render = dict(N_samples=8, N_importance=8, perturb=0.0, chunk=4096)
    jp = {k: jax.device_get(init_nerf_params(jax.random.PRNGKey(i),
                                             JM(**model)))
          for i, k in enumerate(("coarse", "fine"))}

    class J:
        params = jp

    class T:
        params = {k: nerf_params_from_jax(v, device="cpu")
                  for k, v in jp.items()}

    sc = make_box_scene(n_train=2, n_val=1, n_test=126, H=8, W=8, seed=3)
    splits = {"test": sc.i_test, "train": sc.i_train, "val": sc.i_val}
    jt, jS = JP(JL(str(tmp_path / "j")), JE(
        model=JM(**model), render=JR(**render))).stage_pointset(
        J, sc, "lego", splits, p=3)
    pipe = Pipeline(ArtifactLayout(str(tmp_path / "t")), ExperimentConfig(
        model=NeRFModelConfig(**model), render=RenderConfig(**render)),
        device="cpu")
    tt, tS = pipe.stage_pointset(T, sc, "lego", splits, p=3)
    np.testing.assert_allclose(tS, jS, atol=1e-4, rtol=0)
    for split in splits:
        (tw, ti), (jw, ji) = tt[split], jt[split]
        same = ti == ji
        assert same.mean() >= 0.99, split
        np.testing.assert_allclose(tw[same], jw[same], atol=1e-3, rtol=0)
    again, _ = pipe.stage_pointset(T, sc, "lego", splits, p=3)
    for split in splits:
        np.testing.assert_array_equal(again[split][1], tt[split][1])


def test_defense_finetune_is_seeded(world):
    from nerfail_tpu_torch.config import ExperimentConfig
    from nerfail_tpu_torch.models.classifiers.simple_cnn import SimpleCNN
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline

    clean = np.where(world["ori"][..., 3:] > 0, world["ori"][..., :3], 255.0)
    rng = np.random.default_rng(1)
    attacked = np.clip(clean + rng.uniform(-20, 20, clean.shape), 0, 255)
    labels = np.full(4, 7)
    pipe = Pipeline(ArtifactLayout("unused"), ExperimentConfig(),
                    device="cpu")
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        model = SimpleCNN(num_classes=8)
        before = [p.detach().clone() for p in model.parameters()]
        pipe.stage_defense_finetune(model, clean, labels, attacked, labels,
                                    epochs=2, batch_size=4, lr=1e-3)
        after = [p.detach().clone() for p in model.parameters()]
        assert any(not torch.equal(a, b) for a, b in zip(after, before))
        runs.append(after)
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _tiny_nerf_config(path, datadir):
    with open(path, "w") as f:
        f.write(f"""expname = lego
datadir = {datadir}
dataset_type = blender
testskip = 1
netdepth = 2
netwidth = 32
multires = 4
multires_views = 2
N_samples = 8
N_importance = 8
N_rand = 64
chunk = 8192
precrop_iters = 5
i_print = 1000000
i_weights = 1000000
""")


def test_stage_inherit_round_trip(world, tmp_path):
    """δ on the train views → retrain → step-1 renders → eval report."""
    from nerfail_tpu_torch.config import ExperimentConfig
    from nerfail_tpu_torch.data.load import load_scene
    from nerfail_tpu_torch.data.synthetic import (
        make_box_scene, write_blender_format,
    )
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline
    from nerfail_tpu_torch.utils.png import imread

    write_blender_format(make_box_scene(n_train=4, n_val=1, n_test=2, H=H,
                                        W=H, seed=11), str(tmp_path / "s"))
    _tiny_nerf_config(str(tmp_path / "cfg.txt"), str(tmp_path / "s"))
    scene, cfg = load_scene(ExperimentConfig.from_file(
        str(tmp_path / "cfg.txt")))
    pipe = Pipeline(ArtifactLayout(str(tmp_path / "out")), cfg,
                    device="cpu")
    acfg = AttackConfig(method="NeRFail_S", eps=32.0, a=2.0,
                        attack_epochs=1, base_mask_number=2)
    delta = np.zeros((2, H, H, 4), np.float32)
    delta[..., :3] = np.random.default_rng(2).uniform(-20, 20, (2, H, H, 3))
    delta[..., 3] = world["mask_images"][..., 3]
    tables = {"train": world["tables"]}
    state, reports = pipe.stage_inherit(
        scene, "lego", "NeRFail_S", acfg, "simple_cnn", world["t_logits"],
        None, delta, tables, n_iters=10)
    assert state.step == 10
    lay = pipe.layout
    train_dir = lay.attack_dir("simple_cnn", "lego", "NeRFail_S", acfg, 0,
                               "train")
    assert sorted(os.listdir(train_dir)) == sorted(
        [f"r_{i}.png" for i in range(4)] + [f"r_{i}_ori.png" for i in range(4)])
    tag = "simple_cnn_" + lay.attack_method_dirname("NeRFail_S", acfg)
    assert os.path.isdir(lay.nerf_logdir("lego", tag))
    for split, n in (("train", 4), ("val", 1), ("test", 2)):
        d = lay.attack_dir("simple_cnn", "lego", "NeRFail_S", acfg, 1, split)
        assert sorted(os.listdir(d)) == [f"{i:03d}.png" for i in range(n)]
        assert imread(os.path.join(d, "000.png")).shape == (H, H, 3)
    assert list(reports) == ["test"]
    assert 0.0 <= reports["test"]["asr"] <= 1.0
    assert os.path.exists(lay.eval_report_path(
        lay.attack_dir("simple_cnn", "lego", "NeRFail_S", acfg, 1), "test"))


def test_cli_end_to_end_on_the_cpu(tmp_path, capsys):
    """Every command of the CLI at 16² with --device cpu, in the order the
    reference's README runs them; each artifact the JAX package's layout
    names exists."""
    from nerfail_tpu.config import AttackConfig as JA
    from nerfail_tpu.config import SCENE_CLASSES
    from nerfail_tpu.pipeline import ArtifactLayout as JL
    from nerfail_tpu_torch.cli import main
    from nerfail_tpu_torch.data.synthetic import (
        make_box_scene, write_blender_format,
    )
    from nerfail_tpu_torch.utils.png import imread

    root = tmp_path
    # 128 test views so that the mask views (50, 75, 125) exist
    write_blender_format(make_box_scene(n_train=4, n_val=2, n_test=128, H=H,
                                        W=H, seed=0), str(root / "lego"))
    for ci, cls in enumerate(SCENE_CLASSES):
        write_blender_format(make_box_scene(n_train=2, n_val=1, n_test=1,
                                            H=H, W=H, seed=ci, variant=ci),
                             str(root / "classes" / cls))
    _tiny_nerf_config(str(root / "cfg.txt"), str(root / "lego"))
    out = str(root / "out")
    com = ["--config", str(root / "cfg.txt"), "--output", out,
           "--device", "cpu"]
    atk = ["--method", "NeRFail_S", "--label", "lego", "--model_name",
           "simple_cnn", "--attack_epochs", "1"]
    main(["train-nerf", *com, "--n_iters", "10"])
    main(["extract-coords", *com])
    main(["render-only", *com])
    mask = root / "classes" / "lego" / "test" / "r_0.png"
    main(["invert-disturbance", "--input", str(mask),
          "--out", str(root / "inv.png")])
    main(["train-classifier", *com, "--model_name", "simple_cnn",
          "--datadir", str(root / "classes"), "--epochs", "1",
          "--batch_size", "8"])
    main(["attack", *com, *atk])
    main(["evaluate", *com, *atk, "--step", "0"])
    main(["inherit", *com, *atk, "--render_factor", "2", "--n_iters", "5"])
    capsys.readouterr()

    lay = JL(out)
    acfg = JA(method="NeRFail_S", attack_epochs=1)
    assert os.path.exists(os.path.join(lay.nerf_logdir("lego"),
                                       "000010.ckpt"))
    coords = np.load(os.path.join(lay.coords_dir("lego"), "coords.npz"))
    assert coords["coords"].shape == (134, H, H, 3)
    for split, n in (("train", 4), ("val", 2), ("test", 128)):
        d = os.path.join(out, "renders", "lego",
                         f"renderonly_{split}_000009")
        assert len([f for f in os.listdir(d) if f.endswith(".png")]) == n
        assert len([f for f in os.listdir(d) if f.endswith(".npy")]) == n
        assert os.path.exists(lay.tables_path("lego", 3, split))
    inv = imread(str(root / "inv.png"))
    np.testing.assert_array_equal(inv, 255 - imread(str(mask)))
    assert os.path.exists(lay.classifier_best("simple_cnn"))
    step0 = lay.attack_dir("simple_cnn", "lego", "NeRFail_S", acfg)
    test_dir = os.path.join(step0, "test")
    assert len([f for f in os.listdir(test_dir)
                if not f.endswith("_ori.png")]) == 128
    assert os.path.exists(os.path.join(step0, "delta.npy"))
    assert len(os.listdir(lay.attack_masks_dir(step0, "test"))) == 128
    assert os.path.exists(lay.eval_report_path(step0, "test"))
    assert not os.path.exists(os.path.join(step0, "attack_state.npz"))
    step1 = lay.attack_dir("simple_cnn", "lego", "NeRFail_S", acfg, step=1)
    for split in ("train", "val", "test"):
        assert os.listdir(os.path.join(step1, split))
    assert os.path.exists(lay.eval_report_path(step1, "test"))

    with pytest.raises(NotImplementedError, match="multi-GPU"):
        main(["attack", *com, *atk, "--num_devices", "2"])
    with pytest.raises(NotImplementedError, match="annotate"):
        main(["evaluate", *com, *atk, "--annotate"])


def test_port_and_smoke_import_neither_jax_nor_image_libraries():
    """Every module of the port, cli and pipeline included, and
    chip_smoke.py import neither JAX, the JAX package, nor imageio, PIL
    or cv2."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerfail_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'nerfail_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nerfail_tpu', 'imageio', "
        "'PIL', 'cv2'))\n"
        "assert not bad, bad\n"
        "need = {'nerfail_tpu_torch.cli', 'nerfail_tpu_torch.pipeline', "
        "'nerfail_tpu_torch.utils.png', 'nerfail_tpu_torch.data.load'}\n"
        "assert need <= set(names), need - set(names)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40
