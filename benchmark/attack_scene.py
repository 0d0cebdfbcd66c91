"""The attack cells' inputs, made on the device from the seed: the
attacked scene's views and per-pixel surface coordinates, the point set
of the mask views, and the classifier's weights.

The camera model is the attack rig of the port's 800x800 ASR run:
poses at radius 4 looking at the origin (nerf-pytorch's pose_spherical),
azimuths uniform in [-180, 180) and elevations in [-60, -10] degrees, the
lego field of view. The scene is a box of half-width 0.6 with a colour
per face from the seed and a Lambert-like shade; a pixel's coordinate is
its ray's first hit on the box, or the point at depth 4 where it misses,
as the analytic coordinate maps of the port's test scene have it. Every
seed gives the same view count, sizes and pose distribution.
"""

from __future__ import annotations

import math

import torch

from benchmark.scene import generator

POSE_STREAM, COLOUR_STREAM, WEIGHT_STREAM = 21, 22, 23


def pose_spherical(theta: torch.Tensor, phi: torch.Tensor,
                   radius: float) -> torch.Tensor:
    """nerf-pytorch's pose_spherical for [N] angles in degrees."""
    n = theta.shape[0]
    dev = theta.device
    th, ph = theta * math.pi / 180.0, phi * math.pi / 180.0
    eye = torch.eye(4, device=dev).repeat(n, 1, 1)
    trans = eye.clone()
    trans[:, 2, 3] = radius
    rot_phi = eye.clone()
    rot_phi[:, 1, 1], rot_phi[:, 1, 2] = torch.cos(ph), -torch.sin(ph)
    rot_phi[:, 2, 1], rot_phi[:, 2, 2] = torch.sin(ph), torch.cos(ph)
    rot_th = eye.clone()
    rot_th[:, 0, 0], rot_th[:, 0, 2] = torch.cos(th), -torch.sin(th)
    rot_th[:, 2, 0], rot_th[:, 2, 2] = torch.sin(th), torch.cos(th)
    flip = torch.tensor([[-1.0, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                         [0, 0, 0, 1]], device=dev)
    return flip @ rot_th @ rot_phi @ trans


def rig(scene: dict, seed: int, device):
    """(K [3, 3], poses [N, 4, 4]) of the cell's views."""
    n = scene["n_views"]
    u = torch.rand(n, 2, generator=generator(seed, device, POSE_STREAM),
                   device=device)
    lo, hi = scene["elevation_deg"]
    poses = pose_spherical(-180.0 + 360.0 * u[:, 0], lo + (hi - lo) * u[:, 1],
                           scene["radius"])
    f = 0.5 * scene["W"] / math.tan(0.5 * scene["camera_angle_x"])
    K = torch.tensor([[f, 0.0, 0.5 * scene["W"]], [0.0, f, 0.5 * scene["H"]],
                      [0.0, 0.0, 1.0]], device=device)
    return K, poses


def views(scene: dict, K: torch.Tensor, poses: torch.Tensor, seed: int):
    """(uint8 RGBA [N, H, W, 4] 0-255, float32 coordinates [N, H, W, 3]),
    on the poses' device. Alpha is 255 where the ray hits the box."""
    dev = poses.device
    H, W, b = scene["H"], scene["W"], scene["box_half"]
    colours = 0.15 + 0.8 * torch.rand(
        6, 3, generator=generator(seed, dev, COLOUR_STREAM), device=dev)
    light = torch.tensor([0.3, 0.5, 0.8], device=dev)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    dirs = torch.stack([(xs - K[0, 2]) / K[0, 0], -(ys - K[1, 2]) / K[1, 1],
                        -torch.ones_like(xs)], -1).reshape(-1, 3)
    n = poses.shape[0]
    rgba = torch.empty(n, H, W, 4, dtype=torch.uint8, device=dev)
    coords = torch.empty(n, H, W, 3, device=dev)
    for v in range(n):
        d = (dirs[:, None, :] * poses[v, :3, :3]).sum(-1)
        o = poses[v, :3, 3].expand_as(d)
        inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        t0, t1 = (-b - o) * inv, (b - o) * inv
        t_near = torch.minimum(t0, t1).amax(-1)
        t_far = torch.maximum(t0, t1).amin(-1)
        hit = t_far > t_near.clamp(min=0.0)
        t = torch.where(hit, t_near, torch.full_like(t_near, 4.0))
        p = o + d * t[:, None]
        axis = (p.abs() / b).argmax(-1)
        face = axis * 2 + (p.gather(-1, axis[:, None])[:, 0] > 0).long()
        shade = 0.7 + 0.3 * (-(d @ light)).clamp(0.0, 1.0)
        rgb = (colours[face] * shade[:, None] * 255.0).clamp(0, 255)
        rgb = torch.where(hit[:, None], rgb, torch.zeros_like(rgb))
        alpha = hit.to(torch.float32)[:, None] * 255.0
        rgba[v] = torch.cat([rgb, alpha], -1).to(torch.uint8).reshape(H, W, 4)
        coords[v] = p.reshape(H, W, 3)
    return rgba, coords


def classifier_state(model: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for `model`'s parameters from one draw on the device:
    He-normal convolutions (std sqrt(2 / fan_in)), linear layers of std
    1 / sqrt(fan_in) and zero bias, batch norm scale 1 and shift 0. The
    running statistics are left for `calibrate`."""
    state = model.state_dict()
    keys = [k for k, v in state.items() if k.endswith(".weight")
            and v.dim() in (2, 4)]
    sizes = [state[k].numel() for k in keys]
    flat = torch.randn(sum(sizes), device=device,
                       generator=generator(seed, device, WEIGHT_STREAM))
    out = {k: v.to(device).clone() for k, v in state.items()}
    for k, part in zip(keys, torch.split(flat, sizes)):
        w = state[k]
        fan_in = w[0].numel()
        gain = 2.0 if w.dim() == 4 else 1.0
        out[k] = (part * math.sqrt(gain / fan_in)).view(w.shape)
    for k in out:
        if k.endswith("BatchNorm_0.weight"):
            out[k].fill_(1.0)
        elif k.endswith(".bias"):
            out[k].zero_()
    return out
