"""The traced views' MLP forward FLOPs over the traced window, as a
percentage of the bf16 peak."""

from benchmark.counts import nerf as counts
from benchmark.metrics.common import mfu


def read(run):
    flops = run.stats.get("views", 0) * counts.render_view_flops(
        run.cfg["model"], run.cfg["render"], run.stats.get("n_rays", 0))
    return mfu(run, flops)
