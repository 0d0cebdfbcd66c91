"""ResNet-50 (the zoo's `resnet50`).

Ports nerfail_tpu/models/classifiers/resnet.py, torchvision's topology:
explicit torch pads (3 for the 7×7 stem, 1 for every 3×3, a 3×3/2 max
pool with pad 1) and BatchNorm eps 1e-5.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    BatchNorm, Size2, add_child, global_avg_pool, nhwc_to_nchw, scale_input,
)


class RConvBN(nn.Module):
    """Conv (no bias, pad (k-1)//2) + BatchNorm (eps 1e-5) [+ ReLU]."""

    def __init__(self, in_ch: int, features: int, kernel: Size2 = (3, 3),
                 strides: Size2 = (1, 1), use_relu: bool = True):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.Conv_0 = nn.Conv2d(in_ch, features, (kh, kw), strides,
                                ((kh - 1) // 2, (kw - 1) // 2), bias=False)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-5)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.use_relu else x


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int = 1,
                 project: bool = False):
        super().__init__()
        self.RConvBN_0 = RConvBN(in_ch, features, (1, 1))
        self.RConvBN_1 = RConvBN(features, features, (3, 3), strides)
        self.RConvBN_2 = RConvBN(features, features * 4, (1, 1),
                                 use_relu=False)
        if project:
            self.RConvBN_3 = RConvBN(in_ch, features * 4, (1, 1), strides,
                                     use_relu=False)
        self.project = project

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.RConvBN_2(self.RConvBN_1(self.RConvBN_0(x)))
        residual = self.RConvBN_3(x) if self.project else x
        return torch.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 8):
        super().__init__()
        self.RConvBN_0 = RConvBN(3, 64, (7, 7), (2, 2))
        c = 64
        blocks = []
        for stage, n_blocks in enumerate(stage_sizes):
            feats = 64 * 2 ** stage
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(add_child(self, "Bottleneck", Bottleneck(
                    c, feats, strides, project=block == 0)))
                c = feats * 4
        self.blocks = blocks
        self.Dense_0 = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.RConvBN_0(nhwc_to_nchw(scale_input(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for b in self.blocks:
            x = b(x)
        return self.Dense_0(global_avg_pool(x))


def ResNet50(num_classes: int = 8) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes)
