"""PyTorch port: the classifier registry against the JAX registry, and
evaluate_testset against the JAX harness on shared logits."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

from nerfail_tpu_torch.models.classifiers import (  # noqa: E402
    CLASSIFIER_REGISTRY, classifier_input_size, get_classifier,
)


def test_registry_names_aliases_and_sizes_match_jax():
    from nerfail_tpu.models.classifiers import registry as J

    assert list(CLASSIFIER_REGISTRY) == list(J.CLASSIFIER_REGISTRY)
    for name in CLASSIFIER_REGISTRY:
        assert classifier_input_size(name) == J.classifier_input_size(name)
        # the same family: the JAX module's class, by name
        assert (type(get_classifier(name, 5)).__name__
                == type(J.get_classifier(name, 5)).__name__), name
    assert get_classifier("mobilenet").__class__ is \
        get_classifier("mobilenet_v2").__class__
    assert get_classifier("efficientnet").__class__ is \
        get_classifier("efficientnet_b0").__class__
    assert get_classifier("my_cnn").__class__ is \
        get_classifier("my_model").__class__
    assert [classifier_input_size(n) for n in ("swin_b", "vit_b_16",
                                               "mixer_b")] == [224] * 3
    assert [classifier_input_size(n) for n in ("my_model", "my_cnn",
                                               "simple_cnn")] == [None] * 3


def test_registry_models_take_their_input_size_and_class_count():
    import torch

    torch.manual_seed(0)
    for name in ("simple_cnn", "vit_b_16"):
        size = classifier_input_size(name) or 32
        model = get_classifier(name, num_classes=5).eval()
        with torch.no_grad():
            out = model(torch.zeros(1, size, size, 3))
        assert out.shape == (1, 5)


def test_unknown_names_raise_value_error():
    with pytest.raises(ValueError, match="unknown classifier"):
        get_classifier("resnet18")
    with pytest.raises(ValueError, match="unknown classifier"):
        classifier_input_size("resnet18")


def _linear_logits(rng, n_feat=3, n_cls=8):
    """A fixed linear classifier of each image's channel means."""
    A = rng.normal(0, 0.05, (n_feat, n_cls)).astype(np.float32)
    b = rng.normal(0, 1.0, n_cls).astype(np.float32)
    return A, b


def test_evaluate_testset_matches_jax_on_shared_logits():
    import jax.numpy as jnp
    import torch

    from nerfail_tpu.eval.harness import evaluate_testset as J
    from nerfail_tpu_torch.eval.harness import evaluate_testset

    rng = np.random.default_rng(3)
    A, b = _linear_logits(rng)
    images = rng.uniform(0, 255, (21, 6, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 8, 21)
    labels[labels == 7] = 2          # one class with no images
    originals = np.clip(images[labels == 2] + rng.uniform(
        -8, 8, images[labels == 2].shape), 0, 255).astype(np.float32)

    def jfn(x):
        return jnp.mean(x, axis=(1, 2)) @ jnp.asarray(A) + jnp.asarray(b)

    def tfn(x):
        return x.mean(dim=(1, 2)) @ torch.from_numpy(A) + torch.from_numpy(b)

    for kw in ({}, {"attacked_class": 2},
               {"attacked_class": 2, "original_images": originals}):
        want = J(jfn, images, labels, batch_size=4, **kw)
        got = evaluate_testset(tfn, images, labels, batch_size=4,
                               device="cpu", **kw)
        assert set(got) == set(want)
        assert got["per_class"].keys() == want["per_class"].keys()
        for c, w in want["per_class"].items():
            assert got["per_class"][c]["n"] == w["n"]
            assert got["per_class"][c]["acc"] == w["acc"]
            np.testing.assert_allclose(got["per_class"][c]["loss"],
                                       w["loss"], rtol=1e-5)
        for k in set(want) - {"per_class"}:
            if isinstance(want[k], float):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)
            else:
                assert got[k] == want[k], k


def test_evaluate_testset_asr_is_evaluate_attacks():
    import torch

    from nerfail_tpu_torch.eval.harness import (
        evaluate_attack, evaluate_testset,
    )

    rng = np.random.default_rng(4)
    A, b = _linear_logits(rng)
    att = rng.uniform(0, 255, (9, 5, 5, 3)).astype(np.float32)
    ori = rng.uniform(0, 255, (9, 5, 5, 3)).astype(np.float32)

    def fn(x):
        return x.mean(dim=(1, 2)) @ torch.from_numpy(A) + torch.from_numpy(b)

    label = int(np.argmax(ori.mean(axis=(1, 2))[0] @ A + b))
    ts = evaluate_testset(fn, att, np.full(9, label), attacked_class=label,
                          original_images=ori, device="cpu")
    ea = evaluate_attack(fn, att, ori, true_label=label, device="cpu")
    assert ts["asr"] == ea["asr"]
    assert ts["misclass_histogram"] == ea["misclass_histogram"]
    assert ts["psnr_avg"] == ea["psnr_avg"]


def test_evaluate_testset_annotation_waits_for_its_port(tmp_path):
    """The annotated dump has been ported: evaluate_testset writes it for
    the attacked class's rows (tests/test_torch_annotate.py holds it to
    the JAX package's)."""
    from nerfail_tpu_torch.eval.harness import evaluate_testset
    from nerfail_tpu_torch.utils.png import imread

    out = evaluate_testset(lambda x: x.mean(dim=(1, 2)),
                           np.zeros((1, 2, 2, 3), np.float32),
                           np.zeros(1, int), attacked_class=0,
                           annotate_dir=str(tmp_path / "out"), device="cpu")
    assert "asr" in out
    assert os.listdir(tmp_path / "out") == ["r_0.png"]
    assert imread(str(tmp_path / "out" / "r_0.png")).shape == (2, 2, 3)
