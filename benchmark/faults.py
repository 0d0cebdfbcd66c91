"""Faults planted under the timed path, to show that each comparison
that decides `correct` catches what it is there to catch. Used by the
tests and by `controls.py`; a benchmark run never plants one."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer step puts the parameters back as they were: a step
    that returns its state unchanged."""
    step = torch.optim.Adam.step
    # an optimizer built after this wraps `frozen` in the step hooks; call
    # the step inside them, so the hooks run once a step
    inner = step.__wrapped__ if getattr(step, "hooked", False) else step

    def frozen(self, *args, **kwargs):
        with torch.no_grad():
            saved = [p.detach().clone() for g in self.param_groups
                     for p in g["params"]]
        out = inner(self, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups
                             for p in g["params"]), saved):
                p.copy_(s)
        return out

    torch.optim.Adam.step = frozen
    try:
        yield
    finally:
        torch.optim.Adam.step = step


def half_batch(sampler):
    """A sampler whose batches keep their first half of the rays: the loss
    is the mean over the rest."""

    def sample(i, precrop):
        b = sampler(i, precrop)
        n = b["rays_o"].shape[0] // 2
        return {k: v[:n] for k, v in b.items()}

    return sample


@contextlib.contextmanager
def render_fault(kind: str):
    """`render_full_image` under `extract_coord_maps` with its answer
    altered where it is produced: "altered" shifts the colour of one ray
    in 64 by 0.05 and moves its point by 0.2; "half" leaves the second half
    of the rays unrendered (zeros)."""
    from nerfail_tpu_torch.pointset import extract

    render = extract.render_full_image

    def broken(*args, **kwargs):
        out = render(*args, **kwargs)
        rgb, pts = out["rgb_map"].clone(), out["pts_max"].clone()
        flat_rgb, flat_pts = rgb.view(-1, 3), pts.view(-1, 3)
        if kind == "altered":
            flat_rgb[::64] += 0.05
            flat_pts[::64] += 0.2
        elif kind == "half":
            flat_rgb[flat_rgb.shape[0] // 2:] = 0.0
            flat_pts[flat_pts.shape[0] // 2:] = 0.0
        else:
            raise ValueError(kind)
        return {**out, "rgb_map": rgb, "pts_max": pts}

    extract.render_full_image = broken
    try:
        yield
    finally:
        extract.render_full_image = render


@contextlib.contextmanager
def attack_step_fault(kind: str):
    """NeRFail-S's step with "altered": its new perturbation shifted by 2
    on one point in 4 where it is produced, or "half": the second half of
    each batch left out, the loss the mean over the rest."""
    from nerfail_tpu_torch.attacks import nerfail_s

    make = nerfail_s.make_nerfail_s_step

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(delta, delta0, weights, idx, ori, labels, valid, plan):
            if kind == "half":
                valid = valid.clone()
                valid[valid.shape[0] // 2:] = 0.0
            new, metrics = step(delta, delta0, weights, idx, ori, labels,
                                valid, plan)
            if kind == "altered":
                new = new.clone()
                new.view(-1, 4)[::4, :3] += 2.0
            elif kind != "half":
                raise ValueError(kind)
            return new, metrics

        return broken

    nerfail_s.make_nerfail_s_step = make_broken
    try:
        yield
    finally:
        nerfail_s.make_nerfail_s_step = make


@contextlib.contextmanager
def table_fault():
    """NeRFail-S's 8-NN tables altered where set-up produces them: one
    pixel in 61 has its nearest neighbour's index moved on by one."""
    from benchmark.drivers import nerfail_s

    build = nerfail_s.build_neighbor_tables

    def broken(*args, **kwargs):
        weights, idx = build(*args, **kwargs)
        flat = idx.reshape(-1, idx.shape[-1])
        flat[::61, 0] = (flat[::61, 0] + 1) % (flat.max() + 1)
        return weights, idx

    nerfail_s.build_neighbor_tables = broken
    try:
        yield
    finally:
        nerfail_s.build_neighbor_tables = build
