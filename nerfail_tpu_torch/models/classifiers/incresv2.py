"""Inception-ResNet-V2 (the zoo's `incresv2`).

Ports nerfail_tpu/models/classifiers/incresv2.py, after the reference's
vendored Cadene implementation (model/IncResv2.py:34-380): stem →
Mixed_5b → 10×Block35 (scale 0.17) → Mixed_6a → 20×Block17 (scale 0.10)
→ Mixed_7a → 9×Block8 (scale 0.20) → Block8 (no ReLU) → conv 1536 → GAP
→ FC, at 299². The bricks are the inception family's ConvBN (eps 1e-3);
Mixed_5b's pool branch divides by the real elements of each window.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    ConvBN, add_child, avg_pool_nopad, global_avg_pool, nhwc_to_nchw,
    scale_input,
)


def _max3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class Mixed5b(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 96, (1, 1))       # b0
        self.ConvBN_1 = ConvBN(c, 48, (1, 1))       # b1
        self.ConvBN_2 = ConvBN(48, 64, (5, 5))
        self.ConvBN_3 = ConvBN(c, 64, (1, 1))       # b2
        self.ConvBN_4 = ConvBN(64, 96, (3, 3))
        self.ConvBN_5 = ConvBN(96, 96, (3, 3))
        self.ConvBN_6 = ConvBN(c, 64, (1, 1))       # pool branch

    def forward(self, x):
        b0 = self.ConvBN_0(x)
        b1 = self.ConvBN_2(self.ConvBN_1(x))
        b2 = self.ConvBN_5(self.ConvBN_4(self.ConvBN_3(x)))
        b3 = self.ConvBN_6(avg_pool_nopad(x, (3, 3)))
        return torch.cat([b0, b1, b2, b3], dim=1)   # 320


class Block35(nn.Module):
    def __init__(self, c: int, scale: float = 0.17):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 32, (1, 1))       # b0
        self.ConvBN_1 = ConvBN(c, 32, (1, 1))       # b1
        self.ConvBN_2 = ConvBN(32, 32, (3, 3))
        self.ConvBN_3 = ConvBN(c, 32, (1, 1))       # b2
        self.ConvBN_4 = ConvBN(32, 48, (3, 3))
        self.ConvBN_5 = ConvBN(48, 64, (3, 3))
        self.Conv_0 = nn.Conv2d(128, c, 1)
        self.scale = scale

    def forward(self, x):
        b0 = self.ConvBN_0(x)
        b1 = self.ConvBN_2(self.ConvBN_1(x))
        b2 = self.ConvBN_5(self.ConvBN_4(self.ConvBN_3(x)))
        up = self.Conv_0(torch.cat([b0, b1, b2], dim=1))
        return torch.relu(x + self.scale * up)


class Mixed6a(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 384, (3, 3), (2, 2), "VALID")   # b0
        self.ConvBN_1 = ConvBN(c, 256, (1, 1))                    # b1
        self.ConvBN_2 = ConvBN(256, 256, (3, 3))
        self.ConvBN_3 = ConvBN(256, 384, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b0 = self.ConvBN_0(x)
        b1 = self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x)))
        return torch.cat([b0, b1, _max3s2(x)], dim=1)   # 1088


class Block17(nn.Module):
    def __init__(self, c: int, scale: float = 0.10):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 192, (1, 1))      # b0
        self.ConvBN_1 = ConvBN(c, 128, (1, 1))      # b1
        self.ConvBN_2 = ConvBN(128, 160, (1, 7))
        self.ConvBN_3 = ConvBN(160, 192, (7, 1))
        self.Conv_0 = nn.Conv2d(384, c, 1)
        self.scale = scale

    def forward(self, x):
        b0 = self.ConvBN_0(x)
        b1 = self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x)))
        up = self.Conv_0(torch.cat([b0, b1], dim=1))
        return torch.relu(x + self.scale * up)


class Mixed7a(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 256, (1, 1))                    # b0
        self.ConvBN_1 = ConvBN(256, 384, (3, 3), (2, 2), "VALID")
        self.ConvBN_2 = ConvBN(c, 256, (1, 1))                    # b1
        self.ConvBN_3 = ConvBN(256, 288, (3, 3), (2, 2), "VALID")
        self.ConvBN_4 = ConvBN(c, 256, (1, 1))                    # b2
        self.ConvBN_5 = ConvBN(256, 288, (3, 3))
        self.ConvBN_6 = ConvBN(288, 320, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b0 = self.ConvBN_1(self.ConvBN_0(x))
        b1 = self.ConvBN_3(self.ConvBN_2(x))
        b2 = self.ConvBN_6(self.ConvBN_5(self.ConvBN_4(x)))
        return torch.cat([b0, b1, b2, _max3s2(x)], dim=1)   # 2080


class Block8(nn.Module):
    def __init__(self, c: int, scale: float = 0.20, use_relu: bool = True):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 192, (1, 1))      # b0
        self.ConvBN_1 = ConvBN(c, 192, (1, 1))      # b1
        self.ConvBN_2 = ConvBN(192, 224, (1, 3))
        self.ConvBN_3 = ConvBN(224, 256, (3, 1))
        self.Conv_0 = nn.Conv2d(448, c, 1)
        self.scale, self.use_relu = scale, use_relu

    def forward(self, x):
        b0 = self.ConvBN_0(x)
        b1 = self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x)))
        out = x + self.scale * self.Conv_0(torch.cat([b0, b1], dim=1))
        return torch.relu(out) if self.use_relu else out


class InceptionResNetV2(nn.Module):
    def __init__(self, num_classes: int = 8):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = ConvBN(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = ConvBN(32, 64, (3, 3))
        self.ConvBN_3 = ConvBN(64, 80, (1, 1), padding="VALID")
        self.ConvBN_4 = ConvBN(80, 192, (3, 3), padding="VALID")
        blocks = [add_child(self, "Mixed5b", Mixed5b(192))]
        blocks += [add_child(self, "Block35", Block35(320))
                   for _ in range(10)]
        blocks.append(add_child(self, "Mixed6a", Mixed6a(320)))
        blocks += [add_child(self, "Block17", Block17(1088))
                   for _ in range(20)]
        blocks.append(add_child(self, "Mixed7a", Mixed7a(1088)))
        blocks += [add_child(self, "Block8", Block8(2080)) for _ in range(9)]
        blocks.append(add_child(self, "Block8",
                                Block8(2080, scale=1.0, use_relu=False)))
        self.blocks = blocks
        self.ConvBN_5 = ConvBN(2080, 1536, (1, 1))
        self.Dense_0 = nn.Linear(1536, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(scale_input(x))
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = _max3s2(x)
        x = _max3s2(self.ConvBN_4(self.ConvBN_3(x)))
        for b in self.blocks:
            x = b(x)
        return self.Dense_0(global_avg_pool(self.ConvBN_5(x)))
