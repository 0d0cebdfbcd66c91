"""Shared pieces for the classifier zoo.

Contract (matches the reference harness and the JAX package): models take
NHWC float images in **0-255 scale** and return logits [B, num_classes].
Each model maps 0-255 → [-1, 1] as its first op and then runs NCHW, the
layout PyTorch's convolutions expect.

Submodules carry the auto-names flax gives the JAX package's modules
(`ConvBN_3`, `Conv_0`, `BatchNorm_0`, `Dense_0`, ...), so a flax variable
tree maps onto a state_dict by name (models/classifiers/convert.py).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn

Size2 = Union[int, Tuple[int, int]]


def scale_input(x: torch.Tensor) -> torch.Tensor:
    """0-255 float → [-1, 1]."""
    return x / 127.5 - 1.0


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def same_padding(kernel: Size2) -> Tuple[int, int]:
    """flax "SAME" padding for a stride-1 odd kernel."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return (kh - 1) // 2, (kw - 1) // 2


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm (eps 1e-3) + ReLU, the inception brick.

    padding "SAME" (stride 1 only) or "VALID", as in the JAX module."""

    def __init__(self, in_ch: int, features: int, kernel: Size2 = (3, 3),
                 strides: Size2 = (1, 1), padding: str = "SAME",
                 use_relu: bool = True):
        super().__init__()
        if padding == "SAME":
            if strides not in (1, (1, 1)):
                raise ValueError("SAME padding is implemented for stride 1")
            pad = same_padding(kernel)
        elif padding == "VALID":
            pad = (0, 0)
        else:
            raise ValueError(f"unknown padding {padding!r}")
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel, strides, pad,
                                bias=False)
        # flax momentum 0.9 on the running average == torch momentum 0.1
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-3, momentum=0.1)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.use_relu else x


def flax_default_init(module: nn.Module) -> nn.Module:
    """Re-initialise every Conv2d and Linear of `module` as flax does by
    default: kernels lecun_normal (truncated normal, fan-in variance 1,
    cut at ±2σ), biases zero. A model trained from scratch then starts
    from the distribution its JAX twin starts from."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # 0.8796…: std of a unit normal truncated at ±2
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW → [B, C] mean over the spatial axes."""
    return torch.mean(x, dim=(2, 3))
