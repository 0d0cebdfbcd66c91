"""Inception-V3 with auxiliary logits, NHWC 0-255 in, logits out.

The reference's default attack target is torchvision inception_v3 with
aux_logits (getModel 'inception', model/GetModel.py:15-20; aux loss ×0.4
in model_train.py:148-152). Standard V3 topology: stem → 3×InceptionA →
InceptionB → 4×InceptionC → [aux head] → InceptionD → 2×InceptionE →
GAP → dropout → FC, at 299². As in the JAX module, the auxiliary head
runs only in train mode, where the model returns (logits, aux); in eval
mode it returns the logits and the head is not run. The head needs the
17×17 map of a 299² input. Average pools count the padding, as flax's
avg_pool with SAME padding does. Submodule names follow flax's creation
order within each block (ConvBN_0, ConvBN_1, ...), which the comments map
to the branch each conv belongs to.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    ConvBN, global_avg_pool, nhwc_to_nchw, scale_input,
)


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, c: int, pool_features: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 64, (1, 1))       # b1
        self.ConvBN_1 = ConvBN(c, 48, (1, 1))       # b5
        self.ConvBN_2 = ConvBN(48, 64, (5, 5))
        self.ConvBN_3 = ConvBN(c, 64, (1, 1))       # b3
        self.ConvBN_4 = ConvBN(64, 96, (3, 3))
        self.ConvBN_5 = ConvBN(96, 96, (3, 3))
        self.ConvBN_6 = ConvBN(c, pool_features, (1, 1))   # pool branch

    def forward(self, x):
        b1 = self.ConvBN_0(x)
        b5 = self.ConvBN_2(self.ConvBN_1(x))
        b3 = self.ConvBN_5(self.ConvBN_4(self.ConvBN_3(x)))
        bp = self.ConvBN_6(_avg3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 384, (3, 3), (2, 2), "VALID")   # b3
        self.ConvBN_1 = ConvBN(c, 64, (1, 1))                     # bd
        self.ConvBN_2 = ConvBN(64, 96, (3, 3))
        self.ConvBN_3 = ConvBN(96, 96, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b3 = self.ConvBN_0(x)
        bd = self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x)))
        return torch.cat([b3, bd, _max3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c: int, c7: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 192, (1, 1))      # b1
        self.ConvBN_1 = ConvBN(c, c7, (1, 1))       # b7
        self.ConvBN_2 = ConvBN(c7, c7, (1, 7))
        self.ConvBN_3 = ConvBN(c7, 192, (7, 1))
        self.ConvBN_4 = ConvBN(c, c7, (1, 1))       # bd
        self.ConvBN_5 = ConvBN(c7, c7, (7, 1))
        self.ConvBN_6 = ConvBN(c7, c7, (1, 7))
        self.ConvBN_7 = ConvBN(c7, c7, (7, 1))
        self.ConvBN_8 = ConvBN(c7, 192, (1, 7))
        self.ConvBN_9 = ConvBN(c, 192, (1, 1))      # pool branch

    def forward(self, x):
        b1 = self.ConvBN_0(x)
        b7 = self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x)))
        bd = self.ConvBN_4(x)
        for conv in (self.ConvBN_5, self.ConvBN_6, self.ConvBN_7,
                     self.ConvBN_8):
            bd = conv(bd)
        bp = self.ConvBN_9(_avg3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 192, (1, 1))                    # b3
        self.ConvBN_1 = ConvBN(192, 320, (3, 3), (2, 2), "VALID")
        self.ConvBN_2 = ConvBN(c, 192, (1, 1))                    # b7
        self.ConvBN_3 = ConvBN(192, 192, (1, 7))
        self.ConvBN_4 = ConvBN(192, 192, (7, 1))
        self.ConvBN_5 = ConvBN(192, 192, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b3 = self.ConvBN_1(self.ConvBN_0(x))
        b7 = self.ConvBN_5(self.ConvBN_4(self.ConvBN_3(self.ConvBN_2(x))))
        return torch.cat([b3, b7, _max3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 320, (1, 1))      # b1
        self.ConvBN_1 = ConvBN(c, 384, (1, 1))      # b3
        self.ConvBN_2 = ConvBN(384, 384, (1, 3))
        self.ConvBN_3 = ConvBN(384, 384, (3, 1))
        self.ConvBN_4 = ConvBN(c, 448, (1, 1))      # bd
        self.ConvBN_5 = ConvBN(448, 384, (3, 3))
        self.ConvBN_6 = ConvBN(384, 384, (1, 3))
        self.ConvBN_7 = ConvBN(384, 384, (3, 1))
        self.ConvBN_8 = ConvBN(c, 192, (1, 1))      # pool branch

    def forward(self, x):
        b1 = self.ConvBN_0(x)
        b3 = self.ConvBN_1(x)
        b3 = torch.cat([self.ConvBN_2(b3), self.ConvBN_3(b3)], dim=1)
        bd = self.ConvBN_5(self.ConvBN_4(x))
        bd = torch.cat([self.ConvBN_6(bd), self.ConvBN_7(bd)], dim=1)
        bp = self.ConvBN_8(_avg3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionAux(nn.Module):
    def __init__(self, c: int, num_classes: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 128, (1, 1))
        self.ConvBN_1 = ConvBN(128, 768, (5, 5), padding="VALID")
        self.Dense_0 = nn.Linear(768, num_classes)

    def forward(self, x):
        x = F.avg_pool2d(x, 5, 3)
        x = self.ConvBN_1(self.ConvBN_0(x))
        return self.Dense_0(global_avg_pool(x))


class InceptionV3(nn.Module):
    # made by flax's init only in train mode (models/classifiers/convert.py)
    TRAIN_ONLY = ("InceptionAux_0",)

    def __init__(self, num_classes: int = 8, aux_logits: bool = True):
        super().__init__()
        self.aux_logits = aux_logits
        self.ConvBN_0 = ConvBN(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = ConvBN(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = ConvBN(32, 64, (3, 3))
        self.ConvBN_3 = ConvBN(64, 80, (1, 1), padding="VALID")
        self.ConvBN_4 = ConvBN(80, 192, (3, 3), padding="VALID")
        self.InceptionA_0 = InceptionA(192, 32)
        self.InceptionA_1 = InceptionA(256, 64)
        self.InceptionA_2 = InceptionA(288, 64)
        self.InceptionB_0 = InceptionB(288)
        self.InceptionC_0 = InceptionC(768, 128)
        self.InceptionC_1 = InceptionC(768, 160)
        self.InceptionC_2 = InceptionC(768, 160)
        self.InceptionC_3 = InceptionC(768, 192)
        if aux_logits:
            self.InceptionAux_0 = InceptionAux(768, num_classes)
        self.InceptionD_0 = InceptionD(768)
        self.InceptionE_0 = InceptionE(1280)
        self.InceptionE_1 = InceptionE(2048)
        self.dropout = nn.Dropout(0.5)
        self.Dense_0 = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor):
        x = nhwc_to_nchw(scale_input(x))
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = _max3s2(x)
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = _max3s2(x)
        for block in (self.InceptionA_0, self.InceptionA_1,
                      self.InceptionA_2, self.InceptionB_0,
                      self.InceptionC_0, self.InceptionC_1,
                      self.InceptionC_2, self.InceptionC_3):
            x = block(x)
        aux = (self.InceptionAux_0(x) if self.aux_logits and self.training
               else None)
        for block in (self.InceptionD_0, self.InceptionE_0,
                      self.InceptionE_1):
            x = block(x)
        logits = self.Dense_0(self.dropout(global_avg_pool(x)))
        return logits if aux is None else (logits, aux)
