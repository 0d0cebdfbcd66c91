"""The NeRF MLP as a function over an explicit parameter dict.

Architecture of the reference `NeRF` module (run_nerf_helpers.py:71-123):
a D×W ReLU trunk with a skip concat of the encoded input after the layers
in `skips` (default after layer 4, run_nerf.py:188), then the view head:
    alpha   : W → 1            (density)
    feature : W → W
    views   : W+27 → W//2      (one layer, ReLU)
    rgb     : W//2 → 3
Without viewdirs one output layer W → 4 is used.

Parameters are a dict of f32 tensors with the JAX package's names and
[in, out] layout (`pts_{i}_w/b`, `feature_*`, `views_*`, `rgb_*`,
`alpha_*`), so `nerf_params_from_jax` carries JAX weights over unchanged
and the fused kernels (ops/cuda/mlp_kernel.py) read the same matrices.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from nerfail_tpu_torch.config import NeRFModelConfig
from nerfail_tpu_torch.utils.devices import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int):
    bound = 1.0 / np.sqrt(fan_in)
    w = (torch.rand(fan_in, fan_out, generator=gen) * 2.0 - 1.0) * bound
    b = (torch.rand(fan_out, generator=gen) * 2.0 - 1.0) * bound
    return w, b


def init_nerf_params(generator: torch.Generator, cfg: NeRFModelConfig,
                     device: DeviceLike = "cuda") -> Params:
    """U(±1/√fan_in) weights and biases (torch.nn.Linear's init) drawn from
    a CPU `generator`, so a seed gives the same parameters on any device,
    plus `density_init_bias` on the density bias. Leaves require grad."""
    dev = resolve_device(device)
    D, W = cfg.netdepth, cfg.netwidth
    in_ch, in_ch_views = cfg.input_ch, cfg.input_ch_views
    p: Params = {}
    fan_in = in_ch
    for i in range(D):
        p[f"pts_{i}_w"], p[f"pts_{i}_b"] = _linear_init(generator, fan_in, W)
        fan_in = W + in_ch if i in cfg.skips else W
    if cfg.use_viewdirs:
        p["alpha_w"], p["alpha_b"] = _linear_init(generator, W, 1)
        p["alpha_b"] = p["alpha_b"] + cfg.density_init_bias
        p["feature_w"], p["feature_b"] = _linear_init(generator, W, W)
        p["views_w"], p["views_b"] = _linear_init(
            generator, W + in_ch_views, W // 2)
        p["rgb_w"], p["rgb_b"] = _linear_init(generator, W // 2, 3)
    else:
        p["output_w"], p["output_b"] = _linear_init(generator, W,
                                                    cfg.output_ch)
        p["output_b"][3] += cfg.density_init_bias
    return {k: v.to(dev).requires_grad_(True) for k, v in p.items()}


def apply_nerf(params: Params, cfg: NeRFModelConfig, x: torch.Tensor,
               views: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, input_ch] (+ [N, input_ch_views]) → [N, 4] raw rgb + sigma."""
    h = x
    for i in range(cfg.netdepth):
        h = torch.relu(h @ params[f"pts_{i}_w"] + params[f"pts_{i}_b"])
        if i in cfg.skips:
            h = torch.cat([x, h], dim=-1)
    if cfg.use_viewdirs:
        alpha = h @ params["alpha_w"] + params["alpha_b"]
        feature = h @ params["feature_w"] + params["feature_b"]
        h = torch.cat([feature, views], dim=-1)
        h = torch.relu(h @ params["views_w"] + params["views_b"])
        rgb = h @ params["rgb_w"] + params["rgb_b"]
        return torch.cat([rgb, alpha], dim=-1)
    return h @ params["output_w"] + params["output_b"]


def nerf_param_count(params: Params) -> int:
    return sum(int(p.numel()) for p in params.values())


def nerf_params_from_jax(params: Mapping[str, np.ndarray],
                         device: DeviceLike = "cuda") -> Params:
    """The JAX package's parameter dict (numpy arrays, [in, out]) as the
    port's: the same names and layout, f32 leaves that require grad."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
            .requires_grad_(True) for k, v in params.items()}


def load_weights_from_keras(cfg: NeRFModelConfig, weights: list,
                            device: DeviceLike = "cuda") -> Params:
    """Parameters from the official TF/Keras weight list
    (run_nerf_helpers.py:125-152): [kernel, bias] per layer in the order
    trunk (D) → feature → views → rgb → alpha. Keras kernels are already
    [in, out]."""
    if not cfg.use_viewdirs:
        raise ValueError("keras import requires use_viewdirs")
    names = [f"pts_{i}" for i in range(cfg.netdepth)] + [
        "feature", "views", "rgb", "alpha"]
    out = {}
    for j, name in enumerate(names):
        out[f"{name}_w"] = np.asarray(weights[2 * j], np.float32)
        out[f"{name}_b"] = np.asarray(weights[2 * j + 1], np.float32)
    return nerf_params_from_jax(out, device)
