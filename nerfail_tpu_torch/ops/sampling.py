"""Ray sampling: stratified coarse depths and hierarchical inverse-CDF.

Matches nerfail_tpu/ops/sampling.py and the reference
(run_nerf.py:357-381, run_nerf_helpers.py:200-243). Randomness comes from
an explicit `torch.Generator`, or from injected uniforms (`t_rand`, `u`:
the reference's `pytest=True` hooks, which the parity tests feed with the
same numpy draws as the JAX package). With neither, both functions take
the deterministic test-time path.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_z_vals(
    n_rays: int,
    N_samples: int,
    near,
    far,
    lindisp: bool = False,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
    device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """[n_rays, N_samples] depths in [near, far]; near/far are scalars or
    [n_rays, 1] tensors. Jittered within each stratum when a generator or
    `t_rand` (uniforms in [0, 1)) is given, else the plain linspace."""
    if device is None:
        device = (t_rand.device if t_rand is not None
                  else near.device if torch.is_tensor(near) else "cpu")
    t_vals = torch.linspace(0.0, 1.0, N_samples, dtype=dtype, device=device)
    near = torch.as_tensor(near, dtype=dtype, device=device)
    far = torch.as_tensor(far, dtype=dtype, device=device)
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    z_vals = z_vals.expand(n_rays, N_samples)

    if generator is None and t_rand is None:
        return z_vals

    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if t_rand is None:
        t_rand = torch.rand(z_vals.shape, generator=generator, dtype=dtype,
                            device=device)
    return lower + (upper - lower) * t_rand


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    N_samples: int,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of N_samples depths from a piecewise-constant
    pdf. bins [..., M+1] ascending edges, weights [..., M] unnormalized.

    The interval lookup is `torch.searchsorted(cdf, u, right=True)`, with
    below = idx - 1 and above = min(idx, M). The JAX package finds the same
    neighbours with masked max/min reductions (last cdf ≤ u, first cdf > u,
    clamped to the last entry): for a nondecreasing cdf over ascending bins
    the two pick the same entries. The caller detaches the result, as the
    reference does (run_nerf.py:394)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [..., M+1]

    shape = cdf.shape[:-1] + (N_samples,)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, N_samples, dtype=cdf.dtype,
                               device=cdf.device).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, dtype=cdf.dtype,
                           device=cdf.device)
    u = u.contiguous()

    M = cdf.shape[-1] - 1
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=M)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
