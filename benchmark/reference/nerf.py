"""Plain float32 NeRF: nerf-pytorch's encoding, MLP, ray sampling, volume
compositing, loss and Adam (run_nerf.py:262-418, run_nerf_helpers.py,
torch.optim.Adam's update), with no kernel, cache or batching.

Every product goes through `mm`, float32 by default. `fp8_mm` rounds both
operands, and in the backward the output gradient, to float8 e4m3 with a
per-tensor scale: the control, one precision below the bfloat16 products
that the configuration states.

The train cell starts from the program's seeded init, which `init_params`
works out again from the seed: torch.nn.Linear's U(+-1/sqrt(fan_in)) drawn
from one CPU generator, layer by layer (weight [in, out], then bias), the
coarse net and then the fine one, plus `density_init_bias` on the density
bias.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _q8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _q8(x) @ _q8(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gq = _q8(g)
        return gq @ _q8(w).T, _q8(x).T @ gq


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Fp8Mm.apply(x, w)


def layer_names(model: dict) -> List[Tuple[str, int, int]]:
    """(name, fan_in, fan_out) in the order of the init's draws."""
    D, W = model["netdepth"], model["netwidth"]
    in_ch = 3 * (1 + 2 * model["multires"])
    in_views = 3 * (1 + 2 * model["multires_views"])
    out, fan_in = [], in_ch
    for i in range(D):
        out.append((f"pts_{i}", fan_in, W))
        fan_in = W + in_ch if i in model["skips"] else W
    return out + [("alpha", W, 1), ("feature", W, W),
                  ("views", W + in_views, W // 2), ("rgb", W // 2, 3)]


def init_params(seed: int, model: dict, device) -> Dict[str, Params]:
    """{"coarse", "fine"} float32 leaves of a run seeded by `seed`."""
    gen = torch.Generator().manual_seed(seed)
    nets = {}
    for net in ("coarse", "fine"):
        p: Params = {}
        for name, fan_in, fan_out in layer_names(model):
            bound = 1.0 / math.sqrt(fan_in)
            p[f"{name}_w"] = (torch.rand(fan_in, fan_out, generator=gen)
                              * 2.0 - 1.0) * bound
            p[f"{name}_b"] = (torch.rand(fan_out, generator=gen)
                              * 2.0 - 1.0) * bound
        p["alpha_b"] = p["alpha_b"] + model["density_init_bias"]
        nets[net] = {k: v.to(device).requires_grad_(True)
                     for k, v in p.items()}
    return nets


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    parts = [x]
    for k in range(n_freqs):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


def mlp(p: Params, model: dict, pts: torch.Tensor, views: torch.Tensor,
        mm: Mm = f32_mm) -> torch.Tensor:
    """[N, 3] points and [N, 3] unit view directions -> [N, 4] raw rgb and
    density (run_nerf_helpers.py NeRF.forward)."""
    x = encode(pts, model["multires"])
    v = encode(views, model["multires_views"])
    h = x
    for i in range(model["netdepth"]):
        h = torch.relu(mm(h, p[f"pts_{i}_w"]) + p[f"pts_{i}_b"])
        if i in model["skips"]:
            h = torch.cat([x, h], dim=-1)
    alpha = mm(h, p["alpha_w"]) + p["alpha_b"]
    feature = mm(h, p["feature_w"]) + p["feature_b"]
    h = torch.relu(mm(torch.cat([feature, v], -1), p["views_w"])
                   + p["views_b"])
    rgb = mm(h, p["rgb_w"]) + p["rgb_b"]
    return torch.cat([rgb, alpha], dim=-1)


def stratified(n_rays: int, render: dict, t_rand: Optional[torch.Tensor],
               device) -> torch.Tensor:
    """Coarse depths: the linspace of [near, far], jittered in each stratum
    by t_rand when given."""
    t = torch.linspace(0.0, 1.0, render["N_samples"], device=device)
    z = render["near"] * (1.0 - t) + render["far"] * t
    z = z.expand(n_rays, render["N_samples"])
    if t_rand is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
               u: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse-CDF samples (run_nerf_helpers.py sample_pdf); u None is the
    deterministic linspace."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(
            cdf.shape[0], n)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = cdf.gather(-1, below), cdf.gather(-1, above)
    bin_b, bin_a = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bin_b + (u - cdf_b) / denom * (bin_a - bin_b)


def composite(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor,
              white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """raw2outputs without density noise (run_nerf.py:262-305)."""
    dists = z[:, 1:] - z[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[:, None, :], dim=-1)
    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + 1e-10], -1), -1)
    w = alpha * trans
    rgb_map = (w[..., None] * rgb).sum(-2)
    acc = w.sum(-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    return {"rgb": rgb_map, "weights": w}


def render_rays(nets: Dict[str, Params], model: dict, render: dict,
                rays_o: torch.Tensor, rays_d: torch.Tensor,
                t_rand: Optional[torch.Tensor] = None,
                u_pdf: Optional[torch.Tensor] = None,
                mm: Mm = f32_mm) -> Dict[str, torch.Tensor]:
    """Coarse and fine passes of [N, 3] rays: the fine `rgb`, the coarse
    `rgb0` and `pts_max`, the fine sample of largest weight. Without
    t_rand and u_pdf the test-time path (no jitter, linspace inverse-CDF
    uniforms)."""
    n = rays_o.shape[0]
    views = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    z = stratified(n, render, t_rand, rays_o.device)
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
    S = z.shape[1]
    raw = mlp(nets["coarse"], model, pts.reshape(-1, 3),
              views[:, None].expand(n, S, 3).reshape(-1, 3), mm)
    coarse = composite(raw.reshape(n, S, 4), z, rays_d, render["white_bkgd"])
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    zs = sample_pdf(mids, coarse["weights"][:, 1:-1],
                    render["N_importance"], u_pdf).detach()
    z_all, _ = torch.sort(torch.cat([z, zs], -1), -1)
    S = z_all.shape[1]
    pts_f = rays_o[:, None] + rays_d[:, None] * z_all[..., None]
    raw_f = mlp(nets["fine"], model, pts_f.reshape(-1, 3),
                views[:, None].expand(n, S, 3).reshape(-1, 3), mm)
    fine = composite(raw_f.reshape(n, S, 4), z_all, rays_d,
                     render["white_bkgd"])
    top = fine["weights"].argmax(-1)
    pts_max = pts_f[torch.arange(n, device=rays_o.device), top]
    return {"rgb": fine["rgb"], "rgb0": coarse["rgb"], "pts_max": pts_max}


def pixel_rays(K: torch.Tensor, c2w: torch.Tensor, ys: torch.Tensor,
               xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays of pixels (ys, xs) of a pinhole camera K at pose c2w
    (run_nerf_helpers.py get_rays: +x right, +y up, -z forward)."""
    dirs = torch.stack([(xs.float() - K[0, 2]) / K[0, 0],
                        -(ys.float() - K[1, 2]) / K[1, 1],
                        -torch.ones_like(xs, dtype=torch.float32)], -1)
    rays_d = (dirs[:, None, :] * c2w[:3, :3]).sum(-1)
    return c2w[:3, 3].expand_as(rays_d), rays_d


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999, eps 1e-8) over a list
    of leaves, with the learning rate given at each step."""

    def __init__(self, leaves: List[torch.Tensor], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.leaves, self.b1, self.b2, self.eps = leaves, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.leaves, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / c1)


def leaves_of(nets: Dict[str, Params]) -> List[torch.Tensor]:
    return [t for net in ("coarse", "fine") for t in nets[net].values()]


def lr_at(train: dict, step: int) -> float:
    """nerf-pytorch's decay: lrate * 0.1^(step / (lrate_decay * 1000))."""
    return train["lrate"] * 0.1 ** (step / (train["lrate_decay"] * 1000))


def train_steps(nets: Dict[str, Params], model: dict, render: dict,
                train: dict, batches, mm: Mm = f32_mm,
                loss_rows: Optional[int] = None) -> Dict[str, list]:
    """Steps 0, 1, ... of nerf-pytorch's loop over `batches` (dicts of
    rays_o, rays_d, target, t_rand, u_pdf): MSE(fine) + MSE(coarse),
    backward, Adam. Returns each step's loss and, after the first step,
    each leaf's gradient as Adam's first moment gives it back.
    `loss_rows` keeps only the first rows of every batch (a fault)."""
    leaves = leaves_of(nets)
    opt = Adam(leaves)
    losses, grads = [], None
    for i, b in enumerate(batches):
        if loss_rows is not None:
            b = {k: v[:loss_rows] for k, v in b.items()}
        for p in leaves:
            p.grad = None
        out = render_rays(nets, model, render, b["rays_o"], b["rays_d"],
                          b["t_rand"], b["u_pdf"], mm)
        loss = (((out["rgb"] - b["target"]) ** 2).mean()
                + ((out["rgb0"] - b["target"]) ** 2).mean())
        loss.backward()
        opt.step(lr_at(train, i))
        losses.append(float(loss.detach()))
        if i == 0:
            grads = [m / (1.0 - opt.b1) for m in opt.m]
    return {"losses": losses, "grads": grads}
