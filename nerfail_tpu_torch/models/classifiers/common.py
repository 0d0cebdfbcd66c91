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
import torch.nn.functional as F

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


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d with flax's running statistics.

    flax momentum 0.9 on the running average is torch momentum 0.1. In
    train mode both normalise by the batch's biased variance, but torch
    moves `running_var` toward the unbiased one, flax toward the biased
    one; here the buffers move as flax's `batch_stats` do, so a train
    step leaves the statistics its JAX twin leaves."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps=eps, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


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
        self.BatchNorm_0 = BatchNorm(features, eps=1e-3)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.use_relu else x


def add_child(parent: nn.Module, name: str, module: nn.Module) -> nn.Module:
    """Register `module` in `parent` under flax's auto-name `name_i`, i
    counting the children of that name already there; returns it."""
    i = sum(1 for n in parent._modules if n.rsplit("_", 1)[0] == name)
    parent.add_module(f"{name}_{i}", module)
    return module


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


def avg_pool_nopad(x: torch.Tensor, window: Size2 = (3, 3)) -> torch.Tensor:
    """SAME stride-1 average pool that divides each window by the number
    of real elements in it (torch's count_include_pad=False), as the JAX
    package's avg_pool_nopad; flax's avg_pool divides by the full window,
    which differs at the borders."""
    return F.avg_pool2d(x, window, 1, same_padding(window),
                        count_include_pad=False)


def layer_norm(features: int) -> nn.LayerNorm:
    """flax nn.LayerNorm: epsilon 1e-6 (torch's default is 1e-5)."""
    return nn.LayerNorm(features, eps=1e-6)
