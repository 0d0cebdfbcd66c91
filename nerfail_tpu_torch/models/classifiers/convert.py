"""Weight carrier: flax variables of the JAX classifiers → torch state_dict.

The input is the flax variable tree as nested dicts of numpy arrays,
`{"params": ..., "batch_stats": ...}`, as `jax.device_get(variables)`
gives it. The port's modules carry flax's auto-names (`ConvBN_3`,
`Conv_0`, `BatchNorm_0`, `Dense_0`, `LayerNorm_0`, ...), so every leaf
maps to a state_dict key by its path:

    .../Conv_i/kernel       HWIO → weight OIHW     .../Conv_i/bias  → bias
    .../Dense_i/kernel  [in, out] → weight [out, in]   .../Dense_i/bias → bias
    .../{query,key,value,out}/kernel, bias → weight, bias as they are
        (flax DenseGeneral: [D, heads, head_dim] and [heads, head_dim, D])
    .../BatchNorm_i/scale, bias, .../LayerNorm_i/scale, bias → weight, bias
    batch_stats .../BatchNorm_i/mean, var  → running_mean, running_var
    params .../cls, pos_embedding, rel_pos_bias → the parameter of that name

Any leaf that finds no key, any key that finds no leaf, and any shape
that disagrees raises. One exception: a module listed in the model's
`TRAIN_ONLY` (Inception-V3's auxiliary head, `InceptionAux_0`) is made by
flax only when `init` runs in train mode, so a tree from an eval-mode
init has none of it. Such a tree loads into a model that has the head,
whose parameters then keep the values they have (the eval path never
runs it); a head present in part still raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}

# flax parameters declared by name with self.param
_NAMED_PARAMS = ("cls", "pos_embedding", "rel_pos_bias")

# nn.MultiHeadDotProductAttention's DenseGeneral submodules
_DENSE_GENERAL = ("query", "key", "value", "out")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(v)


def _convert_leaf(collection: str, path: Tuple[str, ...],
                  arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *modules, leaf = path
    if collection == "params" and leaf in _NAMED_PARAMS:
        return ".".join(modules + [leaf]), np.ascontiguousarray(arr)
    name = _LEAF_NAMES.get((collection, leaf))
    if name is None or not modules:
        raise ValueError(f"unknown flax leaf {collection}/{'/'.join(path)}")
    owner = modules[-1]
    if leaf == "kernel" and owner.startswith("Conv_"):
        arr = arr.transpose(3, 2, 0, 1)           # HWIO → OIHW
    elif leaf == "kernel" and owner.startswith("Dense_"):
        arr = arr.T                               # [in, out] → [out, in]
    elif leaf == "kernel" and owner not in _DENSE_GENERAL:
        raise ValueError(f"kernel under unknown module {'/'.join(path)}")
    return ".".join(modules + [name]), np.ascontiguousarray(arr)


def flax_to_state_dict(model: nn.Module,
                       variables: Mapping) -> Dict[str, torch.Tensor]:
    """A complete state_dict for `model` (any classifier of the port's zoo)
    from the flax variables of its JAX twin; raises on any unused or
    missing leaf or any shape mismatch."""
    want = model.state_dict()
    absent = tuple(
        m for m in getattr(model, "TRAIN_ONLY", ())
        if hasattr(model, m) and not any(
            m in variables.get(c, {}) for c in ("params", "batch_stats")))
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            key, arr = _convert_leaf(collection, path, arr)
            if key not in want:
                raise ValueError(f"flax leaf {collection}/{'/'.join(path)} "
                                 f"has no counterpart {key!r} in the model")
            if tuple(want[key].shape) != arr.shape:
                raise ValueError(f"{key}: model shape {tuple(want[key].shape)}"
                                 f" != converted {arr.shape}")
            out[key] = torch.from_numpy(arr.astype(np.float32))
    for key, t in want.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(t)
        elif key.split(".")[0] in absent:
            out[key] = t.detach().clone()
        elif key not in out:
            raise ValueError(f"model parameter {key!r} has no flax leaf")
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Carry flax variables into `model` in place; returns the model."""
    model.load_state_dict(flax_to_state_dict(model, variables), strict=True)
    return model
