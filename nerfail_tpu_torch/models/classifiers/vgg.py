"""VGG-16 (the zoo's `vgg16`).

Ports nerfail_tpu/models/classifiers/vgg.py: 3×3 convolutions with bias
(pad 1) and 2×2 max pools, then torchvision's head: an adaptive 7×7
average pool, an NCHW flatten and Linear/ReLU/Dropout ×2 → Linear.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    nhwc_to_nchw, scale_input,
)
from nerfail_tpu_torch.models.classifiers.small_nets import adaptive_avg_pool

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(nn.Module):
    def __init__(self, num_classes: int = 8):
        super().__init__()
        c, i = 3, 0
        for v in VGG16_CFG:
            if v != "M":
                setattr(self, f"Conv_{i}", nn.Conv2d(c, v, 3, padding=1))
                c, i = v, i + 1
        self.dropout = nn.Dropout(0.5)
        self.Dense_0 = nn.Linear(512 * 7 * 7, 4096)
        self.Dense_1 = nn.Linear(4096, 4096)
        self.Dense_2 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(scale_input(x))
        i = 0
        for v in VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = torch.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
        x = torch.flatten(adaptive_avg_pool(x, 7), 1)
        x = self.dropout(torch.relu(self.Dense_0(x)))
        x = self.dropout(torch.relu(self.Dense_1(x)))
        return self.Dense_2(x)
