"""Engine `nerf_render`: `pointset.extract.extract_coord_maps`, one view
per call, on the cell's test poses with weights drawn from the seed.

Set-up makes the poses and the weights on the card and renders one view
(kernel builds, allocator and cuBLAS warm-up at the window's shapes).
The window renders views in turn until `--seconds` have passed and ends
with the view in flight; each call ends in the program's own copy of the
maps to the host. The reference then renders a sample of the window's
rays again, drawn from the seed from its finished views, the last one
among them.
"""

from __future__ import annotations

import math
import time
from typing import List

import torch

from benchmark import scene
from benchmark.drivers.nerf_common import program_config
from benchmark.harness import Check, Context
from benchmark.reference import nerf as ref
from nerfail_tpu_torch.pointset.extract import extract_coord_maps

RIG_STREAM, WEIGHT_STREAM, CHECK_STREAM = 2, 3, 4

def make_weights(model: dict, seed: int, device) -> dict:
    """{"coarse", "fine"} parameter dicts of U(+-1/sqrt(fan_in)), one
    draw per net on the device, plus the configured density bias."""
    layers = ref.layer_names(model)
    nets = {}
    for k, net in enumerate(("coarse", "fine")):
        sizes = [n for _, a, b in layers for n in (a * b, b)]
        flat = torch.rand(sum(sizes), device=device,
                          generator=scene.generator(seed, device,
                                                    WEIGHT_STREAM, k))
        parts = iter(torch.split(flat * 2.0 - 1.0, sizes))
        p = {}
        for name, a, b in layers:
            bound = 1.0 / math.sqrt(a)
            p[f"{name}_w"] = next(parts).view(a, b) * bound
            p[f"{name}_b"] = next(parts) * bound
        p["alpha_b"] = p["alpha_b"] + model["density_init_bias"]
        nets[net] = p
    return nets


def _inputs(ctx: Context):
    sc = ctx.cfg["scene"]
    rig = scene.make_rig(sc, sc["n_test"], ctx.seed, RIG_STREAM, ctx.device)
    return rig, make_weights(ctx.cfg["model"], ctx.seed, ctx.device)


def measure(ctx: Context, tracer=None) -> None:
    pcfg = program_config(ctx.cfg)
    rig, nets = _inputs(ctx)
    ctx.mark("inputs made")
    poses, K = rig.poses.cpu().numpy(), rig.K.cpu().numpy()
    n_poses = poses.shape[0]

    def call(v: int):
        view = v % n_poses
        return view, extract_coord_maps(nets, pcfg, poses[[view]], rig.H,
                                        rig.W, K)

    v = 0
    for _ in range(ctx.traffic["warmup_views"]):
        call(v)
        v += 1
    ctx.mark("warm-up views rendered")
    done: List = []
    t0 = time.perf_counter()
    ctx.stats["setup_end"] = t0
    if tracer is not None:
        tracer.start()
    while True:
        view, (coords, rgbs) = call(v)
        v += 1
        done.append((view, coords, rgbs))
        if tracer is not None and len(done) >= ctx.traffic["traced_views"]:
            tracer.stop()
            break
        if tracer is None and time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    views = len(done)
    n_rays = rig.H * rig.W
    ctx.attempted, ctx.failed = views, 0
    ctx.stats.update(views=views, window_s=window, n_rays=n_rays)
    ctx.e2e["render_rays_per_s"] = n_rays * views / window
    ctx.keep["done"] = done


def sample(ctx: Context, n_done: int):
    """(finished call, [pixel ids]) pairs to check: the last call and
    others drawn from the seed, each with its own pixels."""
    gen = torch.Generator().manual_seed(scene.sub_seed(ctx.seed,
                                                       CHECK_STREAM))
    k = min(ctx.traffic["checked_views"], n_done)
    others = torch.randperm(max(n_done - 1, 1), generator=gen)[:k - 1]
    picks = [n_done - 1] + [int(i) for i in others if int(i) != n_done - 1]
    sc = ctx.cfg["scene"]
    n_px = ctx.traffic["checked_rays_per_view"]
    return [(c, torch.randint(0, sc["H"] * sc["W"], (n_px,), generator=gen))
            for c in picks]


def reference_maps(ctx: Context, rig, nets, view: int, px: torch.Tensor,
                   mm=ref.f32_mm):
    ys, xs = (px // rig.W).to(ctx.device), (px % rig.W).to(ctx.device)
    o, d = ref.pixel_rays(rig.K, rig.poses[view], ys, xs)
    out = []
    for s in range(0, px.shape[0], 1024):
        with torch.no_grad():
            r = ref.render_rays(nets, ctx.cfg["model"], ctx.cfg["render"],
                                o[s:s + 1024], d[s:s + 1024], mm=mm)
        out.append((r["rgb"], r["pts_max"]))
    return (torch.cat([a for a, _ in out]).cpu(),
            torch.cat([b for _, b in out]).cpu())


CHECKS = ("rgb_gap", "pts_gap")


def gaps(prog_rgb, prog_pts, ref_rgb, ref_pts) -> List[float]:
    """(rgb_gap, pts_gap): the largest colour gap of a checked ray, and
    the mean distance between the program's `pts_max` and the
    reference's over the checked rays."""
    rgb_gap = float((prog_rgb - ref_rgb).abs().max())
    dist = torch.linalg.vector_norm((prog_pts - ref_pts).double(), dim=-1)
    return [rgb_gap, float(dist.mean())]


def check(ctx: Context) -> List[Check]:
    done = ctx.keep.pop("done")
    rig, nets = _inputs(ctx)
    p_rgb, p_pts, r_rgb, r_pts = [], [], [], []
    for c, px in sample(ctx, len(done)):
        view, coords, rgbs = done[c]
        p_pts.append(torch.from_numpy(coords[0].reshape(-1, 3)[px.numpy()]))
        p_rgb.append(torch.from_numpy(rgbs[0].reshape(-1, 3)[px.numpy()]))
        a, b = reference_maps(ctx, rig, nets, view, px)
        r_rgb.append(a)
        r_pts.append(b)
    vals = gaps(torch.cat(p_rgb), torch.cat(p_pts), torch.cat(r_rgb),
                torch.cat(r_pts))
    # pts_gap reads 0 for the program and for the float8 control alike
    # (the seeded weights put each ray's largest weight on a coarse
    # sample), so it has no limit to hold: reported, not compared
    ctx.stats["info"] = {"pts_gap": vals[1]}
    return [Check("rgb_gap", vals[0], ctx.limit("rgb_gap"))]
