"""Swin-B (the zoo's `swin_b`).

Ports nerfail_tpu/models/classifiers/swin.py: a 4×4/4 patch embedding,
4 stages of window attention (window 7, shifted by 3 in every other
block, with the shift masks and a relative-position bias table per
block) and patch merging between stages, exact-erf GELU and flax's
LayerNorm (eps 1e-6). Dims 128/256/512/1024, depths (2, 2, 18, 2), heads
(4, 8, 16, 32). It runs channels-last, as the JAX module does.

Sides that the window does not divide take torchvision's padded path
(`shifted_window_attention`, `_patch_merging_pad`): a block pads its
LayerNorm output with zeros on the bottom and right to a multiple of the
window, shifts only where the window is smaller than the padded side,
masks across the shift's regions over the padded grid (padded cells are
not masked as keys: their q, k and v are the qkv bias), and crops after
the reverse roll; patch merging pads an odd side by one zero row or
column. At 299², NeRFail's input, the stages are 74, 37, 19 and 10,
padded to 77, 42, 21 and 14. At sides the window divides (224²) nothing
is padded and the JAX module's arithmetic is kept. A stage smaller than
the window takes the JAX rule: the window becomes its side, unshifted.
The model takes the input size it was built for (the masks are built
then); the registry builds it at 224², the attack's caller at 299².

Spans (utils/profiling.py, no-ops outside a profiler session):
`swin.attention` each block's attention half (LayerNorm to crop),
`swin.mlp` its MLP half, `swin.merge` each patch merging; counters,
from the shapes: `swin.qkv_rows` the rows of each block's qkv
projection, `swin.pad_rows` how many of them are padding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nerfail_tpu_torch.models.classifiers.common import (
    add_child, layer_norm, nhwc_to_nchw, scale_input,
)
from nerfail_tpu_torch.utils.profiling import count, span


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int
                   ) -> torch.Tensor:
    B = wins.shape[0] // (H * W // ws // ws)
    x = wins.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """[ws², ws²] row of the bias table for each pair of window cells."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + ws - 1
    return rel[0] * (2 * ws - 1) + rel[1]


def shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws², ws²] additive mask: -100 between cells that came from
    different regions of the cyclic shift, 0 within one."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    wins = window_partition(torch.from_numpy(img), ws).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff.numpy() != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(
            torch.randn((2 * window - 1) ** 2, num_heads) * 0.02)
        self.Dense_1 = nn.Linear(dim, dim)
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(window).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B_, N, C = x.shape
        h = self.num_heads
        qkv = self.Dense_0(x).reshape(B_, N, 3, h, C // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                # [B_, h, N, d]
        attn = (q * (C // h) ** -0.5) @ k.transpose(-2, -1)
        bias = self.rel_pos_bias[self.rel_index].reshape(N, N, h)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]
            attn = attn.reshape(B_, h, N, N)
        out = torch.softmax(attn, dim=-1) @ v
        return self.Dense_1(out.transpose(1, 2).reshape(B_, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, size: int, window: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws = min(window, size)
        padded = -(-size // self.ws) * self.ws
        self.shift = shift if self.ws < padded else 0
        self.LayerNorm_0 = layer_norm(dim)
        self.WindowAttention_0 = WindowAttention(dim, num_heads, self.ws)
        self.LayerNorm_1 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, int(dim * mlp_ratio))
        self.Dense_1 = nn.Linear(int(dim * mlp_ratio), dim)
        self.register_buffer(
            "mask", torch.from_numpy(shift_mask(padded, padded, self.ws,
                                                self.shift))
            if self.shift else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        s, ws = self.shift, self.ws
        with span("swin.attention"):
            y = F.pad(self.LayerNorm_0(x), (0, 0, 0, -W % ws, 0, -H % ws))
            Hp, Wp = y.shape[1], y.shape[2]
            count("swin.qkv_rows", B * Hp * Wp)
            count("swin.pad_rows", B * (Hp * Wp - H * W))
            if s:
                y = torch.roll(y, (-s, -s), dims=(1, 2))
            wins = self.WindowAttention_0(window_partition(y, ws), self.mask)
            y = window_reverse(wins, ws, Hp, Wp)
            if s:
                y = torch.roll(y, (s, s), dims=(1, 2))
            x = x + y[:, :H, :W]
        with span("swin.mlp"):
            y = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x))))
            return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = layer_norm(4 * dim)
        self.Dense_0 = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("swin.merge"):
            x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
            B, H, W, C = x.shape
            x = x.reshape(B, H // 2, 2, W // 2, 2, C)
            # torchvision's [x00, x10, x01, x11]: the row offset varies fastest
            x = x.permute(0, 1, 3, 4, 2, 5).reshape(B, H // 2, W // 2, 4 * C)
            return self.Dense_0(self.LayerNorm_0(x))


class SwinB(nn.Module):
    def __init__(self, num_classes: int = 8, image_size: int = 224,
                 embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 7):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, embed_dim, 4, 4)
        self.LayerNorm_0 = layer_norm(embed_dim)
        size = image_size // 4
        blocks = []
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** stage
            for b in range(depth):
                blocks.append(add_child(self, "SwinBlock", SwinBlock(
                    dim, heads, size, window,
                    shift=0 if b % 2 == 0 else window // 2)))
            if stage < len(depths) - 1:
                blocks.append(add_child(self, "PatchMerging",
                                        PatchMerging(dim)))
                size = -(-size // 2)
        self.blocks = blocks
        self.LayerNorm_1 = layer_norm(embed_dim * 2 ** (len(depths) - 1))
        self.Dense_0 = nn.Linear(embed_dim * 2 ** (len(depths) - 1),
                                 num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(nhwc_to_nchw(scale_input(x))).permute(0, 2, 3, 1)
        x = self.LayerNorm_0(x)
        for b in self.blocks:
            x = b(x)
        return self.Dense_0(torch.mean(self.LayerNorm_1(x), dim=(1, 2)))
