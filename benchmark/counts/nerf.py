"""FLOPs and bytes of the NeRF MLP (nerf-pytorch's NeRF: a D x W ReLU trunk
with the encoded input concatenated after the layers in `skips`, then
alpha W->1, feature W->W, views (W + views) -> W/2, rgb W/2 -> 3).

A multiply-add counts two FLOPs. Every count is of the work the inputs
need, never of what a kernel recomputes or pads: the backward counts the
input gradients that autograd needs (none for the first layer, whose
input is the encoding of points that need no gradient, and none for the
encoded rows of the skip and view layers) and every weight gradient.
"""

from __future__ import annotations

from typing import List, Tuple


def layer_dims(model: dict) -> List[Tuple[str, int, int, int]]:
    """(name, fan_in, fan_out, rows of fan_in that carry a gradient) of
    every layer, in the order of the forward."""
    D, W = model["netdepth"], model["netwidth"]
    in_ch = 3 * (1 + 2 * model["multires"])
    in_views = 3 * (1 + 2 * model["multires_views"])
    out, fan_in, grad_rows = [], in_ch, 0
    for i in range(D):
        out.append((f"pts_{i}", fan_in, W, grad_rows))
        skip = i in model["skips"]
        fan_in, grad_rows = (W + in_ch, W) if skip else (W, W)
    out += [("alpha", W, 1, W), ("feature", W, W, W),
            ("views", W + in_views, W // 2, W), ("rgb", W // 2, 3, W // 2)]
    return out


def mlp_forward_flops_per_point(model: dict) -> int:
    """FLOPs of one forward of the MLP at one point (the products; biases
    and activations are not counted)."""
    return 2 * sum(a * b for _, a, b, _ in layer_dims(model))


def mlp_backward_flops_per_point(model: dict) -> int:
    """FLOPs of the backward at one point: every weight gradient, and the
    input gradients of the rows that need one."""
    dims = layer_dims(model)
    dw = sum(a * b for _, a, b, _ in dims)
    dx = sum(g * b for _, _, b, g in dims)
    return 2 * (dw + dx)


def points_per_step(render: dict, n_rays: int) -> Tuple[int, int]:
    """Points of the coarse and of the fine pass of one batch of rays."""
    return (n_rays * render["N_samples"],
            n_rays * (render["N_samples"] + render["N_importance"]))


def param_count(model: dict) -> int:
    return sum(a * b + b for _, a, b, _ in layer_dims(model))


def train_step_flops(model: dict, render: dict, n_rays: int) -> float:
    """The MLP's FLOPs in one train step: the coarse and fine forwards, and
    a backward of twice the forward (utils/profiling.nerf_train_step_flops'
    convention, which counts no recompute)."""
    c, f = points_per_step(render, n_rays)
    return 3.0 * mlp_forward_flops_per_point(model) * (c + f)


def render_view_flops(model: dict, render: dict, n_rays: int) -> float:
    """The MLP's forward FLOPs of rendering n_rays rays, coarse and fine."""
    c, f = points_per_step(render, n_rays)
    return float(mlp_forward_flops_per_point(model) * (c + f))


def k4_work(model: dict, n_points: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of K4 over n_points: the forward products in bf16;
    each point's position and direction read once (6 float32), its raw
    rgb-sigma written once (4 float32), the weights read once in bf16 and
    the biases in float32."""
    n_par = param_count(model)
    flops = float(mlp_forward_flops_per_point(model) * n_points)
    nbytes = float(n_points * (6 + 4) * 4 + n_par * 2
                   + sum(b for _, _, b, _ in layer_dims(model)) * 2)
    return flops, nbytes


def k5_work(model: dict, n_points: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of K5 over n_points: the backward of
    `mlp_backward_flops_per_point` in bf16; each point's position and
    direction and the output gradient read once (6 + 4 float32), the
    weights read once in bf16, the weight and bias gradients written once
    in float32."""
    n_par = param_count(model)
    flops = float(mlp_backward_flops_per_point(model) * n_points)
    nbytes = float(n_points * (6 + 4) * 4 + n_par * 2 + n_par * 4)
    return flops, nbytes
