"""The volume renderer: coarse → fine hierarchical rendering of rays.

Ports nerfail_tpu/render.py (the reference's `render → batchify_rays →
render_rays → run_network`, run_nerf.py:27-134,308-418):

  * `query_network`     — encode + MLP: the fused K4/K5 path
                          (ops/cuda/mlp_kernel.py) or encode + apply_nerf
  * `render_rays`       — one ray batch end to end, with `pts_max`, the
                          dominant 3D sample per ray (nerf_to_coord.py:418-423)
  * `render_full_image` — per-pixel rays of one pose, rendered in chunks

Randomness comes from an explicit `torch.Generator`; `t_rand` / `u_pdf`
inject the stratified-jitter and inverse-CDF uniforms (the reference's
`pytest=True` hooks), so tests feed both packages the same draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerfail_tpu_torch.config import NeRFModelConfig, RenderConfig
from nerfail_tpu_torch.models.nerf import Params, apply_nerf
from nerfail_tpu_torch.ops.encoding import positional_encoding
from nerfail_tpu_torch.ops.rays import get_rays, ndc_rays
from nerfail_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals
from nerfail_tpu_torch.ops.volume import raw2outputs
from nerfail_tpu_torch.utils.chunk import chunked_map


def query_network(params: Params, mcfg: NeRFModelConfig, pts: torch.Tensor,
                  viewdirs: Optional[torch.Tensor],
                  use_pallas: Optional[bool] = None) -> torch.Tensor:
    """The NeRF at [N, S, 3] points (+ per-ray [N, 3] viewdirs) → [N, S, 4]
    raw. `use_pallas` None or True takes the fused MLP when the model has
    the viewdir head (K4/K5 on CUDA tensors), False the unfused path
    (run_network, run_nerf.py:37-51)."""
    n_rays, n_samples = pts.shape[:2]
    flat = pts.reshape(-1, 3)
    vd = None
    if mcfg.use_viewdirs and viewdirs is not None:
        vd = viewdirs[:, None, :].expand(n_rays, n_samples, 3).reshape(-1, 3)
    if use_pallas is not False and vd is not None:
        from nerfail_tpu_torch.ops.cuda.mlp_kernel import nerf_mlp_fused

        raw = nerf_mlp_fused(params, mcfg, flat, vd)
    else:
        emb_views = None if vd is None else positional_encoding(
            vd, mcfg.multires_views)
        raw = apply_nerf(params, mcfg, positional_encoding(flat, mcfg.multires),
                         emb_views)
    return raw.reshape(n_rays, n_samples, 4)


def _take_max(pts: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    idx = torch.argmax(weights, dim=-1)          # first maximum, as jnp.argmax
    return torch.gather(pts, 1, idx[:, None, None].expand(-1, 1, 3))[:, 0]


def render_rays(
    params_coarse: Params,
    params_fine: Optional[Params],
    mcfg: NeRFModelConfig,
    rcfg: RenderConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    viewdirs: Optional[torch.Tensor] = None,
    near=None,
    far=None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    t_rand: Optional[torch.Tensor] = None,
    u_pdf: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Render a [N, 3] ray batch. Returns the fine rgb/disp/acc/depth
    maps, coarse `rgb0/disp0/acc0`, `z_std` and `pts_max` (argmax of the
    fine compositing weights)."""
    n_rays = rays_o.shape[0]
    near = rcfg.near if near is None else near
    far = rcfg.far if far is None else far
    if viewdirs is None and mcfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    perturb_on = train and rcfg.perturb > 0.0
    noise_std = rcfg.raw_noise_std if train else 0.0

    z_vals = stratified_z_vals(
        n_rays, rcfg.N_samples, near, far, rcfg.lindisp,
        generator=generator if perturb_on else None, t_rand=t_rand,
        device=rays_o.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw = query_network(params_coarse, mcfg, pts, viewdirs, rcfg.use_pallas)
    coarse = raw2outputs(raw, z_vals, rays_d, raw_noise_std=noise_std,
                         white_bkgd=rcfg.white_bkgd, generator=generator)

    out: Dict[str, torch.Tensor] = {}
    if rcfg.N_importance > 0:
        fine_params = params_fine if params_fine is not None else params_coarse
        z_mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(
            z_mids, coarse["weights"][..., 1:-1], rcfg.N_importance,
            det=not perturb_on and u_pdf is None, generator=generator,
            u=u_pdf).detach()                                 # run_nerf.py:394
        z_all, _ = torch.sort(torch.cat([z_vals, z_samples], -1), dim=-1)
        pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
        raw_f = query_network(fine_params, mcfg, pts_f, viewdirs,
                              rcfg.use_pallas)
        fine = raw2outputs(raw_f, z_all, rays_d, raw_noise_std=noise_std,
                           white_bkgd=rcfg.white_bkgd, generator=generator)
        for k in ("rgb_map", "disp_map", "acc_map", "depth_map"):
            out[k] = fine[k]
        out["rgb0"] = coarse["rgb_map"]
        out["disp0"] = coarse["disp_map"]
        out["acc0"] = coarse["acc_map"]
        out["z_std"] = torch.std(z_samples, dim=-1, correction=0)
        # pixel→3D map: dominant sample of the fine pass after the z merge
        out["pts_max"] = _take_max(pts_f, fine["weights"])
    else:
        for k in ("rgb_map", "disp_map", "acc_map", "depth_map"):
            out[k] = coarse[k]
        out["pts_max"] = _take_max(pts, coarse["weights"])
    return out


@torch.no_grad()
def render_full_image(
    params_coarse: Params,
    params_fine: Optional[Params],
    mcfg: NeRFModelConfig,
    rcfg: RenderConfig,
    H: int,
    W: int,
    K,
    c2w,
) -> Dict[str, torch.Tensor]:
    """Render one pose deterministically (test time: no jitter, no noise),
    `rcfg.chunk` rays at a time, on the parameters' device. Returns
    [H, W, ...] maps including `pts_max` [H, W, 3], the coordinate map the
    point-set stage consumes."""
    dev = params_coarse[next(iter(params_coarse))].device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
    rays_o, rays_d = get_rays(H, W, K, c2w)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    batch = {"o": rays_o, "d": rays_d}
    if rcfg.ndc:
        batch["vd"] = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        batch["o"], batch["d"] = ndc_rays(H, W, float(K[0, 0]), 1.0,
                                          rays_o, rays_d)
        near, far = 0.0, 1.0
    else:
        near, far = rcfg.near, rcfg.far

    def tile_fn(tile):
        return render_rays(params_coarse, params_fine, mcfg, rcfg, tile["o"],
                           tile["d"], tile.get("vd"), near=near, far=far)

    out = chunked_map(tile_fn, batch, rcfg.chunk)
    return {k: v.reshape((H, W) + v.shape[1:]) for k, v in out.items()}
