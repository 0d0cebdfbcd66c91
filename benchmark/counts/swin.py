"""FLOPs of the Swin-B attack cell, from a meta-tensor forward of the
plain reference (nothing is computed): the patch convolution and every
linear layer from its output's shape, and each window attention's
q.k^T and attn.v products over the padded windows from its input's
shape. A multiply-add counts two FLOPs; the bias table, masks, softmax,
LayerNorm, GELU, padding and rolls are not counted."""

from __future__ import annotations

import torch

from benchmark.counts.attack import resize_flops
from benchmark.reference.swin_b import Attention, SwinB


def classifier_forward_flops(c: dict) -> int:
    """FLOPs of one forward of the configuration's Swin-B (its
    `classifier` entry) on one view."""
    with torch.device("meta"):
        model = SwinB(c["num_classes"], c["input_size"], c["embed_dim"],
                      c["depths"], c["num_heads"], c["window"],
                      c["mlp_ratio"])
    total = [0]

    def conv(m, inp, out):
        total[0] += 2 * out.numel() * m.weight[0].numel()

    def linear(m, inp, out):
        total[0] += 2 * out.numel() * m.in_features

    def attention(m, inp, out):
        b, n, c = inp[0].shape                  # [B * windows, ws^2, C]
        total[0] += 2 * 2 * b * n * n * c       # q.k^T and attn.v

    hooks = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, Attention):
            hooks.append(m.register_forward_hook(attention))
    size = c["input_size"]
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3, device="meta"))
    for h in hooks:
        h.remove()
    return total[0]


def nerfail_s_view_flops(cfg: dict) -> float:
    """One view through one sign step: the classifier's forward and its
    input-gradient pass (the same products again, no weight gradients),
    and the resize forward and backward. The clean view's forward, which
    the step recomputes, is not required work and is not counted."""
    c, sc = cfg["classifier"], cfg["scene"]
    rs = resize_flops(sc["H"], sc["W"], 3, c["input_size"])
    return float(2 * classifier_forward_flops(c) + 2 * rs)
