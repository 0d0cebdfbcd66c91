"""Tiny copies of the cells for the CPU tests: the cells' own files with
the widths, depths and sizes cut so that a run takes a second."""

import copy

from benchmark import harness

SEED = 2 ** 31 + 12345


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    c = copy.deepcopy(cell.config)
    if "model" in c:
        c["model"].update(netdepth=4, netwidth=32, skips=[2])
        c["render"].update(N_samples=8, N_importance=8, chunk=256)
        c["train"].update(N_rand=64, i_print=2, precrop_iters=2)
        c["scene"].update(H=16, W=16, n_train=4, n_test=4)
    else:
        c["scene"].update(H=16, W=16, n_views=8)
        c["pointset"]["mask_views"] = [1, 2, 3]
        c["attack"]["batch_size"] = 2
        c["classifier"].update(input_size=75, calibration_views=4)
    w = copy.deepcopy(cell.workload)
    if "log_every" in w["traffic"]:
        w["traffic"]["log_every"] = 2
    if "checked_rays_per_view" in w["traffic"]:
        w["traffic"]["checked_rays_per_view"] = 64
    return harness.Cell(cell.name, w, c, cell.chips, cell.end_to_end,
                        cell.per_layer)
