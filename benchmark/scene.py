"""The NeRF cells' inputs, made on the device from the seed: a Blender-like
camera rig around a textured box, its views, and the train cell's ray
batches.

Poses lie on the sphere of the lego poses (radius 4.0311), looking at the
origin, at azimuths drawn uniformly and elevations in the configured band.
Views are the box rendered analytically: a face colour from the seed,
shaded by a checker of the face coordinates, on a white background. Every
seed gives the same image sizes, pose count and batch shapes, so the work
of a run does not depend on its seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

MASK63 = (1 << 63) - 1


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for one stream of draws of a run seeded by `seed`."""
    h = seed & MASK63
    for p in parts:
        h = (h * 1_000_003 + p + 0x9E3779B9) & MASK63
    return h


def generator(seed: int, device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


@dataclass
class Rig:
    H: int
    W: int
    K: torch.Tensor          # [3, 3]
    poses: torch.Tensor      # [N, 4, 4] camera-to-world


def focal_of(scene: dict) -> float:
    return 0.5 * scene["W"] / math.tan(0.5 * scene["camera_angle_x"])


def make_rig(scene: dict, n: int, seed: int, stream: int, device) -> Rig:
    """n poses on the configured sphere and band of elevations."""
    gen = generator(seed, device, stream)
    u = torch.rand(n, 2, generator=gen, device=device)
    az = 2.0 * math.pi * u[:, 0]
    lo, hi = (math.radians(a) for a in scene["elevation_deg"])
    el = lo + (hi - lo) * u[:, 1]
    eye = scene["radius"] * torch.stack(
        [torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az),
         torch.sin(el)], -1)
    back = eye / torch.linalg.norm(eye, dim=-1, keepdim=True)   # camera +z
    up = torch.tensor([0.0, 0.0, 1.0], device=device).expand_as(back)
    right = torch.linalg.cross(up, back)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    cam_up = torch.linalg.cross(back, right)
    poses = torch.zeros(n, 4, 4, device=device)
    poses[:, :3, 0], poses[:, :3, 1], poses[:, :3, 2] = right, cam_up, back
    poses[:, :3, 3] = eye
    poses[:, 3, 3] = 1.0
    f = focal_of(scene)
    K = torch.tensor([[f, 0.0, 0.5 * scene["W"]], [0.0, f, 0.5 * scene["H"]],
                      [0.0, 0.0, 1.0]], device=device)
    return Rig(scene["H"], scene["W"], K, poses)


def rays_of(rig: Rig, c2w: torch.Tensor, ys: torch.Tensor,
            xs: torch.Tensor):
    """Rays of pixels (ys, xs) of the rig's camera at pose c2w [4, 4]."""
    dirs = torch.stack([(xs.float() - rig.K[0, 2]) / rig.K[0, 0],
                        -(ys.float() - rig.K[1, 2]) / rig.K[1, 1],
                        -torch.ones_like(xs, dtype=torch.float32)], -1)
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    return c2w[:3, 3].expand_as(rays_d), rays_d


def render_box(rig: Rig, scene: dict, seed: int) -> torch.Tensor:
    """[N, H, W, 3] float32 views of the box, white where a ray misses."""
    dev = rig.poses.device
    colours = 0.15 + 0.7 * torch.rand(6, 3, generator=generator(seed, dev, 7),
                                      device=dev)
    b = scene["box_half"]
    ys, xs = torch.meshgrid(torch.arange(rig.H, device=dev),
                            torch.arange(rig.W, device=dev), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    out = torch.empty(rig.poses.shape[0], rig.H, rig.W, 3, device=dev)
    for v in range(rig.poses.shape[0]):
        o, d = rays_of(rig, rig.poses[v], ys, xs)
        inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        t0, t1 = (-b - o) * inv, (b - o) * inv
        t_near = torch.minimum(t0, t1).amax(-1)
        t_far = torch.maximum(t0, t1).amin(-1)
        hit = (t_far > t_near) & (t_far > 0)
        p = o + d * t_near[:, None]
        axis = (p.abs() / b).argmax(-1)                 # the face's axis
        face = axis * 2 + (p.gather(-1, axis[:, None])[:, 0] > 0).long()
        uv = torch.floor((p + b) * 4.0).long().sum(-1) % 2
        rgb = colours[face] * (0.75 + 0.25 * uv[:, None].float())
        out[v] = torch.where(hit[:, None], rgb, torch.ones_like(rgb)).reshape(
            rig.H, rig.W, 3)
    return out


class RaySampler:
    """Step i's batch of the train cell, from (seed, i) alone: one view per
    step (nerf-pytorch's no_batching), n_rays pixels of it, inside the
    central precrop window while precrop holds, their target colours, and
    the renderer's stratified and inverse-CDF uniforms."""

    def __init__(self, rig: Rig, images: torch.Tensor, train: dict,
                 render: dict, seed: int):
        self.rig, self.images, self.seed = rig, images, seed
        self.n, self.frac = train["N_rand"], train["precrop_frac"]
        self.Ns, self.Ni = render["N_samples"], render["N_importance"]

    def __call__(self, i: int, precrop: bool) -> Dict[str, torch.Tensor]:
        dev = self.images.device
        gen = generator(self.seed, dev, 11, i)
        H, W = self.rig.H, self.rig.W
        y0, y1, x0, x1 = 0, H, 0, W
        if precrop:
            dH, dW = int(H // 2 * self.frac), int(W // 2 * self.frac)
            y0, y1, x0, x1 = H // 2 - dH, H // 2 + dH, W // 2 - dW, W // 2 + dW
        # the view stays on the device: no host sync inside a step
        view = torch.randint(0, self.images.shape[0], (1,), generator=gen,
                             device=dev)
        ys = torch.randint(y0, y1, (self.n,), generator=gen, device=dev)
        xs = torch.randint(x0, x1, (self.n,), generator=gen, device=dev)
        c2w = self.rig.poses.index_select(0, view)[0]
        rays_o, rays_d = rays_of(self.rig, c2w, ys, xs)
        return {"rays_o": rays_o.contiguous(), "rays_d": rays_d,
                "target": self.images[view.expand(self.n), ys, xs],
                "t_rand": torch.rand(self.n, self.Ns, generator=gen,
                                     device=dev),
                "u_pdf": torch.rand(self.n, self.Ni, generator=gen,
                                    device=dev)}
