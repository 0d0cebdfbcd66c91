"""PyTorch port: the deeper convolutional families of the zoo against the
JAX modules, as tests/test_torch_zoo_cnn.py holds the others (seeded
random variable trees with randomised BatchNorm statistics, carried
across by convert.load_flax_variables). Input sizes are those of the
executed-torch twin tests (DenseNet 96², ResNet and EfficientNet 128²)
and the 75² Inception-ResNet-V2's VALID stem needs. Tolerance: 1e-4 of
the largest logit (fp32 sums in other orders through 50 to 244
convolutions).
"""

import pytest
import torch

pytest.importorskip("jax")

from tests.test_torch_zoo_cnn import assert_logits_match  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _families():
    from nerfail_tpu.models.classifiers import (
        densenet as jd, efficientnet as je, incresv2 as ji, resnet as jr,
    )
    from nerfail_tpu_torch.models.classifiers import (
        densenet as td, efficientnet as te, incresv2 as ti, resnet as tr,
    )

    # name → (JAX module, port module, size)
    return {
        "resnet50": (jr.ResNet50(), tr.ResNet50(), 128),
        "densenet121": (jd.DenseNet121(), td.DenseNet121(), 96),
        "efficientnet_b0": (je.EfficientNetB0(), te.EfficientNetB0(), 128),
        "incresv2": (ji.InceptionResNetV2(), ti.InceptionResNetV2(), 75),
    }


@pytest.mark.parametrize("name", ["resnet50", "densenet121",
                                  "efficientnet_b0", "incresv2"])
def test_deep_cnn_logits_match_jax(name):
    jm, tm, size = _families()[name]
    assert_logits_match(jm, tm, size, seed=len(name), tol=1e-4)
