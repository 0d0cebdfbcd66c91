"""AlexNet and MobileNetV2 (the zoo's `alexnet` and `mobilenet_v2`).

Ports nerfail_tpu/models/classifiers/small_nets.py: the torchvision
topologies with explicit torch pads, as the JAX modules have them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    BatchNorm, add_child, global_avg_pool, nhwc_to_nchw, scale_input,
)


@lru_cache(maxsize=32)
def _pool_matrix(n: int, out: int) -> np.ndarray:
    """[out, n]: output cell i averages inputs [floor(i·n/out),
    ceil((i+1)·n/out)), as torch's AdaptiveAvgPool2d bins them."""
    m = np.zeros((out, n), np.float32)
    for i in range(out):
        s, e = (i * n) // out, -((-(i + 1) * n) // out)
        m[i, s:e] = 1.0 / (e - s)
    return m


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """AdaptiveAvgPool2d((out, out)) on NCHW as two small matrix products,
    as the JAX package computes it. The height matrix is built from the
    height and the width matrix from the width (the JAX version builds
    both from the height, which is right only for square inputs)."""
    mh = torch.from_numpy(_pool_matrix(x.shape[2], out)).to(x)
    mw = torch.from_numpy(_pool_matrix(x.shape[3], out)).to(x)
    x = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, x)


class AlexNet(nn.Module):
    """torchvision AlexNet: pads 2/2/1/1/1, floor-mode 3×3/2 max pools, an
    adaptive 6×6 average pool, an NCHW flatten and the Dropout → Linear →
    ReLU classifier."""

    def __init__(self, num_classes: int = 8):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 11, 4, 2)
        self.Conv_1 = nn.Conv2d(64, 192, 5, 1, 2)
        self.Conv_2 = nn.Conv2d(192, 384, 3, 1, 1)
        self.Conv_3 = nn.Conv2d(384, 256, 3, 1, 1)
        self.Conv_4 = nn.Conv2d(256, 256, 3, 1, 1)
        self.dropout = nn.Dropout(0.5)
        self.Dense_0 = nn.Linear(256 * 6 * 6, 4096)
        self.Dense_1 = nn.Linear(4096, 4096)
        self.Dense_2 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(scale_input(x))
        x = F.max_pool2d(torch.relu(self.Conv_0(x)), 3, 2)
        x = F.max_pool2d(torch.relu(self.Conv_1(x)), 3, 2)
        x = torch.relu(self.Conv_2(x))
        x = torch.relu(self.Conv_3(x))
        x = F.max_pool2d(torch.relu(self.Conv_4(x)), 3, 2)
        x = torch.flatten(adaptive_avg_pool(x, 6), 1)
        x = torch.relu(self.Dense_0(self.dropout(x)))
        x = torch.relu(self.Dense_1(self.dropout(x)))
        return self.Dense_2(x)


class ConvBNReLU6(nn.Module):
    """torchvision ConvBNReLU: Conv (no bias, pad (k-1)//2) → BN (eps
    1e-5) → ReLU6."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 strides: int = 1, groups: int = 1, use_relu6: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel, strides,
                                (kernel - 1) // 2, groups=groups, bias=False)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-5)
        self.use_relu6 = use_relu6

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu6(x) if self.use_relu6 else x


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int, expand: int):
        super().__init__()
        hidden = in_ch * expand
        layers = []
        if expand != 1:
            layers.append(ConvBNReLU6(in_ch, hidden, 1))
        layers.append(ConvBNReLU6(hidden, hidden, 3, strides, groups=hidden))
        layers.append(ConvBNReLU6(hidden, features, 1, use_relu6=False))
        for m in layers:
            add_child(self, "_ConvBNReLU6", m)
        self.layers = layers
        self.residual = strides == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for m in self.layers:
            y = m(y)
        return x + y if self.residual else y


# (expand, features, repeats, stride): torchvision's
# inverted_residual_setting at width_mult 1
MOBILENET_V2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                    (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                    (6, 320, 1, 1))


class MobileNetV2(nn.Module):
    """torchvision MobileNetV2 (width_mult 1): ReLU6, BN eps 1e-5,
    explicit torch pads, a mean-pool + Dropout(0.2) head."""

    def __init__(self, num_classes: int = 8):
        super().__init__()
        blocks = [ConvBNReLU6(3, 32, 3, 2)]
        c = 32
        for t, f, n, s in MOBILENET_V2_CFG:
            for i in range(n):
                blocks.append(InvertedResidual(c, f, s if i == 0 else 1, t))
                c = f
        blocks.append(ConvBNReLU6(c, 1280, 1))
        for m in blocks:
            add_child(self, "_ConvBNReLU6" if isinstance(m, ConvBNReLU6)
                      else "InvertedResidual", m)
        self.blocks = blocks
        self.dropout = nn.Dropout(0.2)
        self.Dense_0 = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(scale_input(x))
        for m in self.blocks:
            x = m(x)
        return self.Dense_0(self.dropout(global_avg_pool(x)))
