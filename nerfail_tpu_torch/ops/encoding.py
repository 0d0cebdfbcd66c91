"""Fourier positional encoding (reference `Embedder`,
run_nerf_helpers.py:15-67).

Identity concat with sin/cos at frequencies 2^0 .. 2^(L-1) per input
dimension, laid out as

    [x, sin(x·f0), cos(x·f0), sin(x·f1), cos(x·f1), ...]

(each block d-wide), the channel order of nerfail_tpu/ops/encoding.py.
"""

from __future__ import annotations

import torch


def encoder_output_dim(d: int, num_freqs: int, include_input: bool = True) -> int:
    return d * (2 * num_freqs + (1 if include_input else 0))


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode [..., d] → [..., d·(1+2·num_freqs)] (63 channels for d = 3,
    L = 10; 27 for the view directions at L = 4)."""
    if num_freqs == 0:
        return x
    if log_sampling:
        freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs,
                               dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                     # [..., F, d]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)   # [..., F, 2d]
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
