"""The FLOP and byte counts against shapes worked by hand."""

import json
import os

from benchmark.counts import nerf as counts
from benchmark.counts.peaks import H100_SXM, bound_seconds
from benchmark.harness import HERE

# D=2, W=4, skip after layer 0, one octave (9 channels), one view octave
SMALL = {"netdepth": 2, "netwidth": 4, "skips": [0], "multires": 1,
         "multires_views": 1, "density_init_bias": 0.0}


def test_layer_dims_by_hand():
    assert counts.layer_dims(SMALL) == [
        ("pts_0", 9, 4, 0), ("pts_1", 13, 4, 4), ("alpha", 4, 1, 4),
        ("feature", 4, 4, 4), ("views", 13, 2, 4), ("rgb", 2, 3, 2)]


def test_flops_by_hand():
    # products: 9*4 + 13*4 + 4*1 + 4*4 + 13*2 + 2*3 = 140 MACs
    assert counts.mlp_forward_flops_per_point(SMALL) == 280
    # dX rows that need a gradient: 0*4 + 4*4 + 4*1 + 4*4 + 4*2 + 2*3 = 50
    assert counts.mlp_backward_flops_per_point(SMALL) == 2 * (140 + 50)
    assert counts.param_count(SMALL) == 140 + 4 + 4 + 1 + 4 + 2 + 3


def test_step_and_view_counts_by_hand():
    render = {"N_samples": 2, "N_importance": 3}
    assert counts.points_per_step(render, 10) == (20, 50)
    assert counts.train_step_flops(SMALL, render, 10) == 3 * 280 * 70
    assert counts.render_view_flops(SMALL, render, 10) == 280 * 70


def test_kernel_work_by_hand():
    flops, nbytes = counts.k4_work(SMALL, 64)
    assert flops == 280 * 64
    assert nbytes == 64 * 40 + 158 * 2 + (4 + 4 + 1 + 4 + 2 + 3) * 2
    flops, nbytes = counts.k5_work(SMALL, 64)
    assert flops == 380 * 64
    assert nbytes == 64 * 40 + 158 * 6


def test_lego_counts():
    cfg = json.load(open(os.path.join(HERE, "configs",
                                      "nerf_lego_8x256.json")))
    m, r = cfg["model"], cfg["render"]
    assert counts.mlp_forward_flops_per_point(m) == 1_186_816
    assert counts.param_count(m) == 595_844
    assert counts.train_step_flops(m, r, 1024) == 3 * 1_186_816 * 262_144
    # K5's bound at one step: below the 0.9407 ms of the recomputed forward
    c, f = counts.points_per_step(r, 1024)
    k5 = sum(bound_seconds(*counts.k5_work(m, n), H100_SXM.bf16, H100_SXM)
             for n in (c, f))
    assert 0.6e-3 < k5 < 0.62e-3


def test_bound_takes_the_larger():
    assert bound_seconds(989e12, 0.0, 989e12, H100_SXM) == 1.0
    assert bound_seconds(0.0, 3.35e12, 989e12, H100_SXM) == 1.0
