"""EfficientNet-B0 (the zoo's `efficientnet_b0`).

Ports nerfail_tpu/models/classifiers/efficientnet.py: explicit pads of
(k-1)//2 throughout, SiLU, MBConv blocks with a squeeze-excite of
in_feats // 4 channels, BatchNorm eps 1e-5 and a mean-pool +
Dropout(0.2) head.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    BatchNorm, add_child, global_avg_pool, nhwc_to_nchw, scale_input,
)


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, reduced: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(ch, reduced, 1)
        self.Conv_1 = nn.Conv2d(reduced, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.mean(x, dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.Conv_1(F.silu(self.Conv_0(s))))
        return x * s


class MBConv(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int, strides: int,
                 expand: int):
        super().__init__()
        hidden = in_ch * expand
        self.expand = expand != 1
        convs = []
        if self.expand:
            convs.append(nn.Conv2d(in_ch, hidden, 1, bias=False))
        convs.append(nn.Conv2d(hidden, hidden, kernel, strides,
                               (kernel - 1) // 2, groups=hidden, bias=False))
        convs.append(nn.Conv2d(hidden, features, 1, bias=False))
        bns = [BatchNorm(c.out_channels) for c in convs]
        for c, b in zip(convs, bns):
            add_child(self, "Conv", c)
            add_child(self, "BatchNorm", b)
        self.SqueezeExcite_0 = SqueezeExcite(hidden, max(1, in_ch // 4))
        self.convs, self.bns = convs, bns
        self.residual = strides == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for c, b in zip(self.convs[:-1], self.bns[:-1]):
            y = F.silu(b(c(y)))
        y = self.SqueezeExcite_0(y)
        y = self.bns[-1](self.convs[-1](y))
        return x + y if self.residual else y


# (expand, feats, repeats, stride, kernel)
EFFICIENTNET_B0_CFG = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
                       (6, 80, 3, 2, 3), (6, 112, 3, 1, 5),
                       (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))


class EfficientNetB0(nn.Module):
    def __init__(self, num_classes: int = 8):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(32)
        c = 32
        blocks = []
        for t, f, n, s, k in EFFICIENTNET_B0_CFG:
            for i in range(n):
                blocks.append(add_child(self, "MBConv", MBConv(
                    c, f, k, s if i == 0 else 1, t)))
                c = f
        self.blocks = blocks
        self.Conv_1 = nn.Conv2d(c, 1280, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(1280)
        self.dropout = nn.Dropout(0.2)
        self.Dense_0 = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(nhwc_to_nchw(scale_input(x)))
        x = F.silu(self.BatchNorm_0(x))
        for b in self.blocks:
            x = b(x)
        x = F.silu(self.BatchNorm_1(self.Conv_1(x)))
        return self.Dense_0(self.dropout(global_avg_pool(x)))
