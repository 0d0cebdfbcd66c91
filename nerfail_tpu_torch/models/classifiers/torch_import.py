"""Reference torch tensors → the port's classifiers, by order.

Ports nerfail_tpu/models/classifiers/torch_import.py. The reference's
classifiers are torch modules (GetModel.py:13-51, IncResv2.py:334-380),
and a checkpoint of one is a `state_dict` whose names are the reference's
(`conv2d_1a.conv.weight`, ...), not the port's flax-style names
(`ConvBN_0.Conv_0.weight`). Both register one parameter unit per
Conv/BatchNorm/Linear in the order the model first calls them, so the
import is an order-zip of units:

  conv.weight [O, I, kh, kw], conv.bias             → Conv2d weight, bias
  bn.weight, bn.bias, running_mean, running_var     → BatchNorm2d, the same
  linear.weight [O, I], linear.bias                 → Linear weight, bias

The port's tensors already have torch's layout, so nothing is transposed.
The order is taken from the port's module as it runs, not from its
`state_dict` (which follows `__init__`): forward pre-hooks record the
first call of every Conv2d, BatchNorm2d and Linear during an eval-mode
forward on meta tensors, which computes shapes only. A unit the forward
never calls (Inception-V3's auxiliary head in eval mode) is left out, as
flax leaves a module that `init` never calls out of its tree. Every
assignment is shape-checked; a count or shape mismatch raises ValueError
naming the parameter.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

_UNITS = (nn.Conv2d, nn.BatchNorm2d, nn.Linear)


def _call_order(model: nn.Module, size: int) -> List[Tuple[str, nn.Module]]:
    """(name, module) of every Conv2d / BatchNorm2d / Linear in the order
    of its first call by an eval-mode forward of a [1, size, size, 3]
    input, run on meta tensors."""
    order: List[Tuple[str, nn.Module]] = []
    seen = set()
    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, _UNITS):
            def hook(m, _args, name=name):
                if name not in seen:
                    seen.add(name)
                    order.append((name, m))
            handles.append(mod.register_forward_pre_hook(hook))
    meta = {k: torch.empty_like(v, device="meta")
            for k, v in list(model.named_parameters())
            + list(model.named_buffers())}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            torch.func.functional_call(
                model, meta, (torch.empty(1, size, size, 3, device="meta"),))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return order


def _units(model: nn.Module, size: int) -> List[Tuple[str, str, torch.Tensor]]:
    """(kind, parameter name, tensor) in the reference's registration
    order: Conv weight[, bias]; BatchNorm weight, bias, running_mean,
    running_var; Linear weight, bias."""
    seq = []
    for name, m in _call_order(model, size):
        if isinstance(m, nn.BatchNorm2d):
            leaves = (("bn_scale", "weight"), ("bn_bias", "bias"),
                      ("bn_mean", "running_mean"), ("bn_var", "running_var"))
        else:
            kind = "conv" if isinstance(m, nn.Conv2d) else "dense"
            leaves = ((kind + "_kernel", "weight"), (kind + "_bias", "bias"))
        for kind, leaf in leaves:
            t = getattr(m, leaf)
            if t is not None:
                seq.append((kind, f"{name}.{leaf}", t))
    return seq


def torch_tensor_shapes(model: nn.Module, size: int = 800
                        ) -> List[Tuple[str, Tuple[int, ...]]]:
    """The (kind, shape) sequence of the reference's state_dict for
    `model` (kinds as the JAX importer names them: conv_kernel,
    conv_bias, bn_scale, bn_bias, bn_mean, bn_var, dense_kernel,
    dense_bias). `size` is the input's side for the forward that finds
    the order; only shapes are computed, so the 800² that MyCNN needs
    costs nothing."""
    return [(kind, tuple(t.shape)) for kind, _, t in _units(model, size)]


def import_torch_state(model: nn.Module, tensors: Sequence[np.ndarray],
                       size: int = 800) -> nn.Module:
    """Copy `tensors` (the reference state_dict's values in registration
    order without `num_batches_tracked`, as `state_dict_tensors` gives
    them) into `model` in place; returns the model. Raises ValueError on a
    count mismatch or, naming the parameter, on a shape mismatch; nothing
    is copied then."""
    seq = _units(model, size)
    if len(seq) != len(tensors):
        raise ValueError(
            f"tensor count mismatch: the port's model has {len(seq)} "
            f"tensors, the torch side provides {len(tensors)}")
    pairs = []
    for (kind, name, dst), src in zip(seq, tensors):
        src = torch.as_tensor(np.asarray(src, np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch at {name} ({kind}): torch "
                             f"{tuple(src.shape)} vs port {tuple(dst.shape)}")
        pairs.append((dst, src))
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src)
    return model


def state_dict_tensors(state_dict: Dict) -> List[np.ndarray]:
    """Torch state_dict → ordered tensor list (drops num_batches_tracked)."""
    return [
        np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
        for k, v in state_dict.items()
        if not k.endswith("num_batches_tracked")
    ]
