"""FLOPs and bytes of the attack cells: Inception-V3 from its layer shapes,
the antialiased resize from its nonzero weights, and K1's bytes from the
plan a batch needs. A multiply-add counts two FLOPs; biases, batch norm,
pools and activations are not counted."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.attack import resize_matrix
from benchmark.reference.inception_v3 import InceptionV3


def classifier_forward_flops(num_classes: int, size: int) -> int:
    """FLOPs of one forward of Inception-V3 at size x size, from the shape
    of every convolution's and linear layer's output (a meta-tensor
    forward: nothing is computed)."""
    model = InceptionV3(num_classes, aux_logits=False).to("meta")
    total = [0]

    def conv(m, inp, out):
        total[0] += 2 * out.numel() * m.weight[0].numel()

    def linear(m, inp, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = []
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3, device="meta"))
    for h in hooks:
        h.remove()
    return total[0]


def resize_flops(h: int, w: int, c: int, size: int) -> int:
    """FLOPs of the resize of one [h, w, c] view to size x size, counting
    only the nonzero weights of each axis's matrix: the W axis over h
    rows, then the H axis over `size` columns."""
    nnz_w = int((resize_matrix(w, size, "cpu") != 0).sum())
    nnz_h = int((resize_matrix(h, size, "cpu") != 0).sum())
    return 2 * c * (h * nnz_w + size * nnz_h)


def nerfail_s_view_flops(cfg: dict) -> float:
    """One view through one sign step: the classifier's forward and its
    input-gradient pass (the same products again, no weight gradients),
    and the resize forward and backward. The clean view's forward, which
    the step recomputes, is not required work and is not counted."""
    c, sc = cfg["classifier"], cfg["scene"]
    fwd = classifier_forward_flops(c["num_classes"], c["input_size"])
    rs = resize_flops(sc["H"], sc["W"], 3, c["input_size"])
    return float(2 * fwd + 2 * rs)


def k1_bytes(pairs: int, pixels: int, rows: int) -> float:
    """Bytes that K1's splat backward of one batch must move: each kept
    pair's pixel index and weight (4 + 4), each foreground pixel's RGBA
    gradient (16) read once, and each touched row's id read (4) and RGBA
    sum written (16) once."""
    return float(8 * pairs + 16 * pixels + 20 * rows)


@torch.no_grad()
def batch_plan_sizes(idx: torch.Tensor, alpha: torch.Tensor) -> Dict[str, int]:
    """(pairs, pixels, rows) of one batch's splat backward: the pairs of
    foreground pixels (alpha > 0; a background pixel's gradient is zero)
    and the distinct points they touch."""
    fg = alpha.reshape(-1) > 0
    kept = idx.reshape(-1, idx.shape[-1])[fg]
    return {"pairs": int(kept.numel()), "pixels": int(fg.sum()),
            "rows": int(torch.unique(kept).numel())}
