"""Classifier factory: the reference's getModel (model/GetModel.py:13-51).

Ports nerfail_tpu/models/classifiers/registry.py with the same names,
aliases and input sizes: 224² for swin_b, vit_b_16 and mixer_b, no resize
for my_model, my_cnn and simple_cnn, 299² for every other model. Swin-B
is listed at the JAX registry's 224², where every stage divides into 7×7
windows; the port's SwinB also runs torchvision's padded windows, so a
caller that follows the reference's GetModel builds SwinB(8,
image_size=299) and passes resize_to=299 to the attack. Models come from
torch's default initialisation under the caller's torch.manual_seed;
weights of a JAX twin load with convert.load_flax_variables.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch.nn as nn

from nerfail_tpu_torch.models.classifiers.densenet import DenseNet121
from nerfail_tpu_torch.models.classifiers.efficientnet import EfficientNetB0
from nerfail_tpu_torch.models.classifiers.inception_v3 import InceptionV3
from nerfail_tpu_torch.models.classifiers.incresv2 import InceptionResNetV2
from nerfail_tpu_torch.models.classifiers.resnet import ResNet50
from nerfail_tpu_torch.models.classifiers.simple_cnn import MyCNN, SimpleCNN
from nerfail_tpu_torch.models.classifiers.small_nets import (
    AlexNet, MobileNetV2,
)
from nerfail_tpu_torch.models.classifiers.swin import SwinB
from nerfail_tpu_torch.models.classifiers.vgg import VGG16
from nerfail_tpu_torch.models.classifiers.vit import MlpMixer, ViT

# name → (constructor of num_classes, input size or None for the raw 800²)
CLASSIFIER_REGISTRY: Dict[
    str, Tuple[Callable[[int], nn.Module], Optional[int]]] = {
    "inception": (InceptionV3, 299),
    "incresv2": (InceptionResNetV2, 299),
    "resnet50": (ResNet50, 299),
    "vgg16": (VGG16, 299),
    "alexnet": (AlexNet, 299),
    "mobilenet_v2": (MobileNetV2, 299),
    # the reference's spellings (GetModel.py:28-32)
    "mobilenet": (MobileNetV2, 299),
    "densenet121": (DenseNet121, 299),
    "efficientnet_b0": (EfficientNetB0, 299),
    "efficientnet": (EfficientNetB0, 299),
    "swin_b": (SwinB, 224),
    "vit_b_16": (ViT, 224),
    "mixer_b": (MlpMixer, 224),
    # my_model is the reference's MyCNN, pinned to 800²; my_cnn its alias;
    # simple_cnn the resolution-free redesign
    "my_model": (MyCNN, None),
    "my_cnn": (MyCNN, None),
    "simple_cnn": (SimpleCNN, None),
}


def get_classifier(name: str, num_classes: int = 8) -> nn.Module:
    if name not in CLASSIFIER_REGISTRY:
        raise ValueError(
            f"unknown classifier '{name}'; have {sorted(CLASSIFIER_REGISTRY)}"
        )
    return CLASSIFIER_REGISTRY[name][0](num_classes)


def classifier_input_size(name: str) -> Optional[int]:
    """Edge length the attack and eval pipelines resize to (None = keep
    800²)."""
    if name not in CLASSIFIER_REGISTRY:
        raise ValueError(f"unknown classifier '{name}'")
    return CLASSIFIER_REGISTRY[name][1]
