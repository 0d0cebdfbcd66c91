"""Plain Inception-V3 forward in eval mode (Szegedy et al., CVPR 2016;
torchvision's inception_v3 topology), frozen here for the attack cells:
NHWC 0-255 input scaled to [-1, 1], stem, 3 x A, B, 4 x C, D, 2 x E,
global average pool, linear. Convolutions carry no bias and are followed
by batch normalisation (eps 1e-3, running statistics) and ReLU; average
pools count the padding. The auxiliary head is held so that a state dict
with it loads, and never runs (eval mode).

Submodule names are those of the program's classifier, so one state dict
loads into both; every operation is plain torch in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBN(nn.Module):
    calibrating = False     # set by `calibrate`

    def __init__(self, cin, cout, kernel=(3, 3), stride=(1, 1), pad="SAME"):
        super().__init__()
        kh, kw = kernel
        padding = ((kh - 1) // 2, (kw - 1) // 2) if pad == "SAME" else (0, 0)
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride, padding,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.BatchNorm_0
        x = self.Conv_0(x)
        if ConvBN.calibrating:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return torch.relu(x)


def _avg3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max3s2(x):
    return F.max_pool2d(x, 3, 2)


class A(nn.Module):
    def __init__(self, c, pool):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 64, (1, 1))
        self.ConvBN_1 = ConvBN(c, 48, (1, 1))
        self.ConvBN_2 = ConvBN(48, 64, (5, 5))
        self.ConvBN_3 = ConvBN(c, 64, (1, 1))
        self.ConvBN_4 = ConvBN(64, 96, (3, 3))
        self.ConvBN_5 = ConvBN(96, 96, (3, 3))
        self.ConvBN_6 = ConvBN(c, pool, (1, 1))

    def forward(self, x):
        return torch.cat([
            self.ConvBN_0(x), self.ConvBN_2(self.ConvBN_1(x)),
            self.ConvBN_5(self.ConvBN_4(self.ConvBN_3(x))),
            self.ConvBN_6(_avg3(x))], 1)


class B(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 384, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = ConvBN(c, 64, (1, 1))
        self.ConvBN_2 = ConvBN(64, 96, (3, 3))
        self.ConvBN_3 = ConvBN(96, 96, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        return torch.cat([
            self.ConvBN_0(x),
            self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x))), _max3s2(x)], 1)


class C(nn.Module):
    def __init__(self, c, c7):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 192, (1, 1))
        self.ConvBN_1 = ConvBN(c, c7, (1, 1))
        self.ConvBN_2 = ConvBN(c7, c7, (1, 7))
        self.ConvBN_3 = ConvBN(c7, 192, (7, 1))
        self.ConvBN_4 = ConvBN(c, c7, (1, 1))
        self.ConvBN_5 = ConvBN(c7, c7, (7, 1))
        self.ConvBN_6 = ConvBN(c7, c7, (1, 7))
        self.ConvBN_7 = ConvBN(c7, c7, (7, 1))
        self.ConvBN_8 = ConvBN(c7, 192, (1, 7))
        self.ConvBN_9 = ConvBN(c, 192, (1, 1))

    def forward(self, x):
        bd = self.ConvBN_4(x)
        for conv in (self.ConvBN_5, self.ConvBN_6, self.ConvBN_7,
                     self.ConvBN_8):
            bd = conv(bd)
        return torch.cat([
            self.ConvBN_0(x), self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x))),
            bd, self.ConvBN_9(_avg3(x))], 1)


class D(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 192, (1, 1))
        self.ConvBN_1 = ConvBN(192, 320, (3, 3), (2, 2), "VALID")
        self.ConvBN_2 = ConvBN(c, 192, (1, 1))
        self.ConvBN_3 = ConvBN(192, 192, (1, 7))
        self.ConvBN_4 = ConvBN(192, 192, (7, 1))
        self.ConvBN_5 = ConvBN(192, 192, (3, 3), (2, 2), "VALID")

    def forward(self, x):
        b7 = self.ConvBN_5(self.ConvBN_4(self.ConvBN_3(self.ConvBN_2(x))))
        return torch.cat([self.ConvBN_1(self.ConvBN_0(x)), b7, _max3s2(x)],
                         1)


class E(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 320, (1, 1))
        self.ConvBN_1 = ConvBN(c, 384, (1, 1))
        self.ConvBN_2 = ConvBN(384, 384, (1, 3))
        self.ConvBN_3 = ConvBN(384, 384, (3, 1))
        self.ConvBN_4 = ConvBN(c, 448, (1, 1))
        self.ConvBN_5 = ConvBN(448, 384, (3, 3))
        self.ConvBN_6 = ConvBN(384, 384, (1, 3))
        self.ConvBN_7 = ConvBN(384, 384, (3, 1))
        self.ConvBN_8 = ConvBN(c, 192, (1, 1))

    def forward(self, x):
        b3 = self.ConvBN_1(x)
        bd = self.ConvBN_5(self.ConvBN_4(x))
        return torch.cat([
            self.ConvBN_0(x),
            torch.cat([self.ConvBN_2(b3), self.ConvBN_3(b3)], 1),
            torch.cat([self.ConvBN_6(bd), self.ConvBN_7(bd)], 1),
            self.ConvBN_8(_avg3(x))], 1)


class Aux(nn.Module):
    def __init__(self, c, n):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, 128, (1, 1))
        self.ConvBN_1 = ConvBN(128, 768, (5, 5), pad="VALID")
        self.Dense_0 = nn.Linear(768, n)


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 8, aux_logits: bool = True):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = ConvBN(32, 32, (3, 3), pad="VALID")
        self.ConvBN_2 = ConvBN(32, 64, (3, 3))
        self.ConvBN_3 = ConvBN(64, 80, (1, 1), pad="VALID")
        self.ConvBN_4 = ConvBN(80, 192, (3, 3), pad="VALID")
        self.InceptionA_0 = A(192, 32)
        self.InceptionA_1 = A(256, 64)
        self.InceptionA_2 = A(288, 64)
        self.InceptionB_0 = B(288)
        self.InceptionC_0 = C(768, 128)
        self.InceptionC_1 = C(768, 160)
        self.InceptionC_2 = C(768, 160)
        self.InceptionC_3 = C(768, 192)
        if aux_logits:
            self.InceptionAux_0 = Aux(768, num_classes)
        self.InceptionD_0 = D(768)
        self.InceptionE_0 = E(1280)
        self.InceptionE_1 = E(2048)
        self.Dense_0 = nn.Linear(2048, num_classes)

    def features(self, x: torch.Tensor):
        """The activations after each stage, for the batch statistics."""
        x = (x / 127.5 - 1.0).permute(0, 3, 1, 2)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = self.ConvBN_4(self.ConvBN_3(_max3s2(x)))
        x = _max3s2(x)
        for name in ("InceptionA_0", "InceptionA_1", "InceptionA_2",
                     "InceptionB_0", "InceptionC_0", "InceptionC_1",
                     "InceptionC_2", "InceptionC_3", "InceptionD_0",
                     "InceptionE_0", "InceptionE_1"):
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 299, 299, 3] 0-255 -> [B, classes] logits (eval mode)."""
        return self.Dense_0(self.features(x).mean(dim=(2, 3)))


@torch.no_grad()
def calibrate(model: InceptionV3, x: torch.Tensor) -> None:
    """Set every running mean and variance to the statistics of the batch
    x (NHWC 0-255) as it reaches that layer, layer by layer in the order
    of the forward, so that activations and logits are of order one."""
    ConvBN.calibrating = True
    try:
        model.features(x)
    finally:
        ConvBN.calibrating = False
