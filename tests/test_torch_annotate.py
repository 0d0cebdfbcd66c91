"""PyTorch port, slice 11: the annotated-prediction dump
(eval/harness.annotate_predictions, utils/font.py) against the JAX
package's (cv2.putText + imageio).

The port draws its own 5×7 bitmap font (the card's machine has no cv2),
so the text's pixels differ from cv2's Hershey triplex. What must match
exactly: the file names, the label and confidence string, its origin,
scale and colour (the JAX call is recorded with cv2.putText and
imageio's imwrite monkeypatched). The port's images are checked on their
own: every pixel outside the text box is the input's, and every pixel it
changed inside carries the predicted class's colour.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from nerfail_tpu_torch.eval.harness import (  # noqa: E402
    ANNOTATE_COLORS, annotate_predictions, annotation_text,
    evaluate_testset,
)
from nerfail_tpu_torch.utils.font import CELL, ROWS, dot_size  # noqa: E402
from nerfail_tpu_torch.utils.png import imread  # noqa: E402


def _inputs(n=3, size=64, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-10, 265, (n, size, size, 3)).astype(np.float32)
    logits = rng.normal(0, 3, (n, 8)).astype(np.float32)
    return images, logits


def _jax_calls(images, logits, indices, monkeypatch, tmp_path):
    """What the JAX package's annotate_predictions asks cv2 and imageio
    to do: [(file name, text, org, scale, color)]."""
    import cv2
    import imageio.v2 as imageio

    from nerfail_tpu.eval.harness import annotate_predictions as j_annotate

    calls, names = [], []
    monkeypatch.setattr(cv2, "putText", lambda img, text, org, **kw:
                        calls.append((text, org, kw["fontScale"],
                                      kw["color"])))
    monkeypatch.setattr(imageio, "imwrite",
                        lambda path, img: names.append(
                            os.path.basename(path)))
    j_annotate(images, logits, str(tmp_path / "jax"), indices=indices)
    return [(n,) + c for n, c in zip(names, calls)]


@pytest.mark.parametrize("size,indices", [(64, None), (800, [7, 3, 120])])
def test_names_text_and_placement_equal_the_jax_package(
        size, indices, monkeypatch, tmp_path):
    images, logits = _inputs(size=size)
    idx = None if indices is None else np.asarray(indices)
    want = _jax_calls(images, logits, idx, monkeypatch, tmp_path)
    out = tmp_path / "port"
    annotate_predictions(images, logits, str(out), indices=idx)
    names = [f"r_{i}.png" for i in (range(3) if idx is None else idx)]
    assert sorted(os.listdir(out)) == sorted(names)
    texts = annotation_text(logits)
    for (name, text, org, scale, color), (pred, ours) in zip(want, texts):
        assert ours == text
        assert org == (size // 8, size // 8)
        assert scale == max(size / 800.0, 0.3)
        assert tuple(ANNOTATE_COLORS[pred]) == tuple(color)
    assert [w[0] for w in want] == names


def test_pixels_outside_the_text_box_are_untouched(tmp_path):
    size = 96
    images, logits = _inputs(size=size, seed=1)
    annotate_predictions(images, logits, str(tmp_path))
    d = dot_size(max(size / 800.0, 0.3))
    for j, (pred, text) in enumerate(annotation_text(logits)):
        got = imread(str(tmp_path / f"r_{j}.png"))
        base = np.clip(images[j], 0, 255).astype(np.uint8)
        y1 = size // 8 + 1                      # the baseline row is drawn
        y0, x0 = y1 - ROWS * d, size // 8
        x1 = min(x0 + CELL * d * len(text), size)
        outside = np.ones((size, size), bool)
        outside[y0:y1, x0:x1] = False
        np.testing.assert_array_equal(got[outside], base[outside])
        changed = (got != base).any(-1)
        assert changed[y0:y1, x0:x1].sum() > 0
        # every changed pixel, and every drawn one, has the class colour
        drawn = (got == np.asarray(ANNOTATE_COLORS[pred], np.uint8)).all(-1)
        assert not (changed & ~drawn).any()
        assert drawn[y0:y1, x0:x1].sum() >= changed.sum()


def test_text_is_drawn_in_the_predicted_class_colour(tmp_path):
    """A grey image of each class's prediction: the only new colour is
    that class's, and each class's label is drawn."""
    size = 64
    images = np.full((8, size, size, 3), 128.0, np.float32)
    logits = np.eye(8, dtype=np.float32) * 10
    annotate_predictions(images, logits, str(tmp_path))
    for c in range(8):
        got = imread(str(tmp_path / f"r_{c}.png")).reshape(-1, 3)
        colours = {tuple(p) for p in np.unique(got, axis=0)}
        assert colours == {(128, 128, 128), tuple(ANNOTATE_COLORS[c])}


def test_evaluate_testset_annotates_the_attacked_rows(tmp_path):
    """The attacked class's rows, named by their frame indices, as the JAX
    package's evaluate_testset dumps them; other classes are not drawn."""
    import torch

    images, _ = _inputs(n=5, size=32, seed=2)
    labels = np.array([4, 1, 4, 4, 2])
    W = np.random.default_rng(3).normal(0, 1, (3, 8)).astype(np.float32)

    def fn(x):
        return x.mean(dim=(1, 2)) @ torch.from_numpy(W)

    out = evaluate_testset(fn, images, labels, attacked_class=4,
                           annotate_dir=str(tmp_path / "ann"),
                           indices=np.array([10, 11, 12, 13, 14]),
                           device="cpu")
    assert "asr" in out
    assert sorted(os.listdir(tmp_path / "ann")) == [
        "r_10.png", "r_12.png", "r_13.png"]
    assert imread(str(tmp_path / "ann" / "r_12.png")).shape == (32, 32, 3)


def test_stage_eval_full_writes_the_annotated_dump(tmp_path):
    """Pipeline.stage_eval_full(annotate_dir=...) (what `cli evaluate
    --annotate` runs; tests/test_torch_pipeline.py runs the command) on an
    8-class root whose attacked class comes from an override directory."""
    import torch

    from nerfail_tpu_torch.config import ExperimentConfig, SCENE_CLASSES
    from nerfail_tpu_torch.data.synthetic import (
        make_box_scene, write_blender_format,
    )
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline
    from nerfail_tpu_torch.utils.png import imwrite

    root = tmp_path / "classes"
    for ci, cls in enumerate(SCENE_CLASSES):
        write_blender_format(make_box_scene(n_train=1, n_val=1, n_test=2,
                                            H=16, W=16, seed=ci, variant=ci),
                             str(root / cls))
    att = tmp_path / "attacked"
    att.mkdir()
    rng = np.random.default_rng(0)
    for i in (0, 1):
        imwrite(str(att / f"r_{i}.png"),
                rng.integers(0, 256, (16, 16, 4), dtype=np.uint8))
    pipe = Pipeline(ArtifactLayout(str(tmp_path / "out")), ExperimentConfig(),
                    device="cpu")
    rep = pipe.stage_eval_full(
        lambda x: x.mean(dim=(1, 2)) @ torch.ones(3, 8), str(root), "test",
        "lego", override_dir=str(att), annotate_dir=str(tmp_path / "ann"))
    assert "asr" in rep
    assert sorted(os.listdir(tmp_path / "ann")) == ["r_0.png", "r_1.png"]
