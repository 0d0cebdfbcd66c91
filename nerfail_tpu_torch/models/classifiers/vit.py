"""ViT-B/16 and MLP-Mixer B/16 (the zoo's `vit_b_16` and `mixer_b`).

Ports nerfail_tpu/models/classifiers/vit.py at 224² by default: a 16×16/16
patch conv, tokens in row-major patch order, exact-erf GELU, flax's
LayerNorm (eps 1e-6), and ViT's attention written as flax's
nn.MultiHeadDotProductAttention computes it, with its DenseGeneral
kernels kept in their flax shapes ([D, heads, head_dim] for the query,
key and value, [heads, head_dim, D] for the output). The learned
position embedding and the Mixer's token-mixing MLP are sized by the
token count, so the models take the input size they were built for.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    add_child, layer_norm, nhwc_to_nchw, scale_input,
)


class DenseGeneral(nn.Module):
    """flax DenseGeneral: `weight` in flax's kernel shape, contracted over
    the input's last `n_in` axes."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))
        self.n_in = len(in_shape)
        nn.init.normal_(self.weight, std=math.prod(in_shape) ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(x, self.weight, dims=self.n_in) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        hd = dim // num_heads
        self.query = DenseGeneral((dim,), (num_heads, hd))
        self.key = DenseGeneral((dim,), (num_heads, hd))
        self.value = DenseGeneral((dim,), (num_heads, hd))
        self.out = DenseGeneral((num_heads, hd), (dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, T, h, d]
        q = q / q.shape[-1] ** 0.5
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", attn, v))


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.gelu(self.Dense_0(x)))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.LayerNorm_0 = layer_norm(dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, num_heads)
        self.LayerNorm_1 = layer_norm(dim)
        self.MlpBlock_0 = MlpBlock(dim, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        return x + self.MlpBlock_0(self.LayerNorm_1(x))


def _patches(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """NHWC 0-255 → [B, T, D] patch tokens in row-major patch order."""
    y = conv(nhwc_to_nchw(scale_input(x)))
    return y.flatten(2).transpose(1, 2)


class ViT(nn.Module):
    """ViT-B/16: 12 layers, 12 heads, width 768, mlp 3072, patch 16."""

    def __init__(self, num_classes: int = 8, image_size: int = 224,
                 patch: int = 16, width: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072):
        super().__init__()
        tokens = (image_size // patch) ** 2
        self.Conv_0 = nn.Conv2d(3, width, patch, patch)
        self.cls = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embedding = nn.Parameter(
            torch.randn(1, tokens + 1, width) * 0.02)
        self.blocks = [add_child(self, "EncoderBlock",
                                 EncoderBlock(width, num_heads, mlp_dim))
                       for _ in range(depth)]
        self.LayerNorm_0 = layer_norm(width)
        self.Dense_0 = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _patches(self.Conv_0, x)
        x = torch.cat([self.cls.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embedding
        for b in self.blocks:
            x = b(x)
        return self.Dense_0(self.LayerNorm_0(x)[:, 0])


class MixerBlock(nn.Module):
    def __init__(self, tokens: int, dim: int, tokens_mlp_dim: int,
                 channels_mlp_dim: int):
        super().__init__()
        self.LayerNorm_0 = layer_norm(dim)
        self.MlpBlock_0 = MlpBlock(tokens, tokens_mlp_dim)
        self.LayerNorm_1 = layer_norm(dim)
        self.MlpBlock_1 = MlpBlock(dim, channels_mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.MlpBlock_0(self.LayerNorm_0(x).transpose(1, 2))
        x = x + y.transpose(1, 2)
        return x + self.MlpBlock_1(self.LayerNorm_1(x))


class MlpMixer(nn.Module):
    """Mixer-B/16: 12 blocks, width 768, token mlp 384, channel mlp 3072."""

    def __init__(self, num_classes: int = 8, image_size: int = 224,
                 patch: int = 16, width: int = 768, depth: int = 12,
                 tokens_mlp_dim: int = 384, channels_mlp_dim: int = 3072):
        super().__init__()
        tokens = (image_size // patch) ** 2
        self.Conv_0 = nn.Conv2d(3, width, patch, patch)
        self.blocks = [add_child(self, "MixerBlock", MixerBlock(
            tokens, width, tokens_mlp_dim, channels_mlp_dim))
            for _ in range(depth)]
        self.LayerNorm_0 = layer_norm(width)
        self.Dense_0 = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _patches(self.Conv_0, x)
        for b in self.blocks:
            x = b(x)
        return self.Dense_0(torch.mean(self.LayerNorm_0(x), dim=1))
