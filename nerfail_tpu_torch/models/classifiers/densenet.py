"""DenseNet-121 (the zoo's `densenet121`).

Ports nerfail_tpu/models/classifiers/densenet.py: torchvision's geometry
with explicit pads (a 7×7/2 stem with pad 3, a 3×3/2 max pool with pad
1), BN → ReLU → 1×1 → BN → ReLU → 3×3 dense layers of growth 32, and
BN → ReLU → 1×1 → 2×2/2 average-pool transitions. BatchNorm eps 1e-5.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    BatchNorm, add_child, global_avg_pool, nhwc_to_nchw, scale_input,
)


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth: int = 32):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_0 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(4 * growth)
        self.Conv_1 = nn.Conv2d(4 * growth, growth, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(torch.relu(self.BatchNorm_0(x)))
        y = self.Conv_1(torch.relu(self.BatchNorm_1(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_0 = nn.Conv2d(in_ch, in_ch // 2, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(torch.relu(self.BatchNorm_0(x)))
        return F.avg_pool2d(y, 2, 2)


class DenseNet(nn.Module):
    def __init__(self, block_sizes: Sequence[int] = (6, 12, 24, 16),
                 growth: int = 32, num_classes: int = 8):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        c = 64
        blocks = []
        for bi, n_layers in enumerate(block_sizes):
            for _ in range(n_layers):
                blocks.append(add_child(self, "DenseLayer",
                                        DenseLayer(c, growth)))
                c += growth
            if bi != len(block_sizes) - 1:
                blocks.append(add_child(self, "Transition", Transition(c)))
                c //= 2
        self.blocks = blocks
        self.BatchNorm_1 = BatchNorm(c)
        self.Dense_0 = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(nhwc_to_nchw(scale_input(x)))
        x = F.max_pool2d(torch.relu(self.BatchNorm_0(x)), 3, 2, 1)
        for b in self.blocks:
            x = b(x)
        x = torch.relu(self.BatchNorm_1(x))
        return self.Dense_0(global_avg_pool(x))


def DenseNet121(num_classes: int = 8) -> DenseNet:
    return DenseNet(block_sizes=(6, 12, 24, 16), num_classes=num_classes)
