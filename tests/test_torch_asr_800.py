"""PyTorch port: the 800² trained-Inception data and trainer
(eval/asr_800.py) against the JAX package's rehearsal classifier
(tools/full_rehearsal.py:188-275), at small sizes.

The renders must be bit-equal to the JAX tool's (the same numpy shading
and poses), the resized training images allclose to the JAX package's
`resize_batch` (1e-3 on the 0-255 scale: the same f32 matrices, summed
in another order), and the trainer must hand back the weights of its
best validation epoch. Inception's auxiliary head needs 299² inputs in
train mode, so the trainer runs 2 epochs on 2 views a class at 299².
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.eval import asr_800  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_class_views_match_the_jax_tool():
    from tools.full_rehearsal import _render_class_views

    for variant, seed in ((0, 100), (5, 905)):
        np.testing.assert_array_equal(
            asr_800.render_class_views(variant, 3, 40, seed),
            _render_class_views(variant, 3, 40, seed))


def test_class_data_is_the_attack_preprocessing():
    from nerfail_tpu.attacks.forward import resize_batch
    from tools.full_rehearsal import _render_class_views

    data = asr_800.class_data(size=48, resize=24, n_train=2, n_val=1,
                              device="cpu")
    assert data["tr_x"].shape == (16, 24, 24, 3)
    assert data["va_x"].shape == (8, 24, 24, 3)
    np.testing.assert_array_equal(data["tr_y"], np.repeat(np.arange(8), 2))
    np.testing.assert_array_equal(data["va_y"], np.arange(8))
    for c in (0, 7):
        want = np.asarray(resize_batch(jnp.asarray(
            _render_class_views(c, 2, 48, 100 + c)), 24))
        np.testing.assert_allclose(data["tr_x"][2 * c:2 * c + 2], want,
                                   rtol=0, atol=1e-3)
        want = np.asarray(resize_batch(jnp.asarray(
            _render_class_views(c, 1, 48, 900 + c)), 24))
        np.testing.assert_allclose(data["va_x"][c:c + 1], want, rtol=0,
                                   atol=1e-3)


def test_train_inception_keeps_its_best_validation_epoch():
    from nerfail_tpu_torch.train.classifier_trainer import (
        evaluate_accuracy,
    )

    data = asr_800.class_data(size=299, resize=299, n_train=2, n_val=1,
                              device="cpu")
    logged = []
    model, info = asr_800.train_inception(
        data, device="cpu", epochs=2, log_fn=lambda e, m: logged.append(m))
    assert info["history"] == logged and len(logged) == 2
    assert info["val_acc"] == max(m["val_acc"] for m in logged)
    assert logged[info["best_epoch"]]["val_acc"] == info["val_acc"]
    assert not model.training and model.aux_logits
    assert evaluate_accuracy(model, data["va_x"], data["va_y"],
                             device="cpu") == info["val_acc"]
