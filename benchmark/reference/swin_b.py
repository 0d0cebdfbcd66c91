"""Plain Swin-B forward in eval mode (Liu et al., ICCV 2021; torchvision's
swin_b, `swin_transformer.py`: `shifted_window_attention` and
`_patch_merging_pad`), frozen here for the attack cell at 299x299.

A 4x4/4 patch embedding and LayerNorm, 4 stages of blocks and a patch
merging between stages, LayerNorm, the mean over the grid, linear. A
block is

  x = x + crop(roll+(reverse(attn(partition(roll-(pad(LN(x)))))))
  x = x + W2 gelu(W1 LN(x))          (exact-erf GELU)

where pad adds zeros on the bottom and right up to a multiple of the
window, the shift (half the window, every other block) is 0 on an axis
whose padded side the window covers, the attention adds a learned
relative-position bias (a [(2w-1)^2, heads] table) and, in a shifted
block, -100 between cells of different regions of the shifted padded
grid. Padded cells are attended as keys like any other: their q, k and
v are the qkv bias. Patch merging pads an odd side with one zero row or
column and concatenates [x00, x10, x01, x11] before LayerNorm and a
linear map without bias.

Departures from torchvision, each to hold the program to its own
contract:
- LayerNorm eps 1e-6, the program's and its JAX twin's; torchvision's
  is 1e-5.
- The input is NHWC 0-255, scaled to [-1, 1] (the classifier zoo's
  contract); torchvision takes normalised NCHW.
- A stage whose side is smaller than the window takes a window of its
  side, unshifted (the JAX twin's rule); torchvision pads it to the
  window. No configuration here reaches that case.

Submodule names are those of the program's classifier, so one state dict
loads into both. Every operation is plain torch in float32: the forward
runs under `fp32()`, TF32 off for matrix products and cuDNN and the
flags put back after; a caller that takes the reference's gradient holds
`fp32()` around the backward too.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-6


@contextlib.contextmanager
def fp32():
    """TF32 off for matrix products and cuDNN inside; the flags as they
    were after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def relative_position_index(ws: int) -> torch.Tensor:
    """[ws^2 * ws^2] rows of the bias table, as torchvision builds them."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (ws - 1)
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).flatten()


class Attention(nn.Module):
    """Multi-head attention inside each window: [B*nW, N, C] -> same."""

    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.Dense_0 = nn.Linear(dim, 3 * dim)                 # qkv
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * ws - 1) ** 2,
                                                     heads))
        self.Dense_1 = nn.Linear(dim, dim)                     # proj
        self.register_buffer("index", relative_position_index(ws),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, n, c = x.shape
        h = self.heads
        qkv = self.Dense_0(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1,
                                                                  4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * (c // h) ** -0.5).matmul(k.transpose(-2, -1))
        bias = self.rel_pos_bias[self.index].view(n, n, h).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, h, n, n) + mask[None, :, None]
            attn = attn.view(b, h, n, n)
        attn = F.softmax(attn, dim=-1)
        x = attn.matmul(v).transpose(1, 2).reshape(b, n, c)
        return self.Dense_1(x)


def shift_mask(pad_h: int, pad_w: int, ws: int, shift, device):
    """[nW, N, N] -100 between cells of different regions, as torchvision
    builds it over the padded grid."""
    m = torch.zeros((pad_h, pad_w), device=device)
    hs = ((0, -ws), (-ws, -shift[0]), (-shift[0], None))
    vs = ((0, -ws), (-ws, -shift[1]), (-shift[1], None))
    n = 0
    for h in hs:
        for w in vs:
            m[h[0]:h[1], w[0]:w[1]] = n
            n += 1
    m = m.view(pad_h // ws, ws, pad_w // ws, ws).permute(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    m = m[:, None, :] - m[:, :, None]
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


def shifted_window_attention(x: torch.Tensor, attn: Attention,
                             shift_size: int) -> torch.Tensor:
    """torchvision's shifted_window_attention on [B, H, W, C]."""
    B, H, W, C = x.shape
    ws = attn.ws
    pad_r, pad_b = (ws - W % ws) % ws, (ws - H % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    _, pad_h, pad_w, _ = x.shape
    shift = [0 if ws >= pad_h else shift_size,
             0 if ws >= pad_w else shift_size]
    if sum(shift) > 0:
        x = torch.roll(x, shifts=(-shift[0], -shift[1]), dims=(1, 2))
    nh, nw = pad_h // ws, pad_w // ws
    x = x.view(B, nh, ws, nw, ws, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B * nh * nw, ws * ws, C)
    mask = (shift_mask(pad_h, pad_w, ws, shift, x.device)
            if sum(shift) > 0 else None)
    x = attn(x, mask)
    x = x.view(B, nh, nw, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, pad_h, pad_w, C)
    if sum(shift) > 0:
        x = torch.roll(x, shifts=(shift[0], shift[1]), dims=(1, 2))
    return x[:, :H, :W, :].contiguous()


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.shift = shift
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=EPS)
        self.WindowAttention_0 = Attention(dim, heads, ws)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=EPS)
        self.Dense_0 = nn.Linear(dim, int(dim * mlp_ratio))
        self.Dense_1 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + shifted_window_attention(self.LayerNorm_0(x),
                                         self.WindowAttention_0, self.shift)
        return x + self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x))))


class Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(4 * dim, eps=EPS)
        self.Dense_0 = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.Dense_0(self.LayerNorm_0(x))


class SwinB(nn.Module):
    def __init__(self, num_classes: int = 8, image_size: int = 299,
                 embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 7,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, embed_dim, 4, 4)
        self.LayerNorm_0 = nn.LayerNorm(embed_dim, eps=EPS)
        side = (image_size - 4) // 4 + 1
        self.order = []
        n_merge = 0
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** stage
            for b in range(depth):
                name = f"SwinBlock_{len(self.order) - n_merge}"
                setattr(self, name, Block(dim, heads, min(window, side),
                                          window // 2 if b % 2 else 0,
                                          mlp_ratio))
                self.order.append(name)
            if stage < len(depths) - 1:
                name = f"PatchMerging_{n_merge}"
                setattr(self, name, Merge(dim))
                self.order.append(name)
                n_merge += 1
                side = (side + 1) // 2
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=EPS)
        self.Dense_0 = nn.Linear(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] 0-255 -> [B, classes] logits (eval mode)."""
        with fp32():
            x = self.Conv_0((x / 127.5 - 1.0).permute(0, 3, 1, 2))
            x = self.LayerNorm_0(x.permute(0, 2, 3, 1))
            for name in self.order:
                x = getattr(self, name)(x)
            return self.Dense_0(self.LayerNorm_1(x).mean(dim=(1, 2)))
