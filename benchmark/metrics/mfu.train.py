"""The traced train steps' MLP FLOPs (`counts.nerf.train_step_flops`) over
the traced window, as a percentage of the bf16 peak."""

from benchmark.counts import nerf as counts
from benchmark.metrics.common import mfu


def read(run):
    flops = run.stats.get("steps", 0) * counts.train_step_flops(
        run.cfg["model"], run.cfg["render"], run.cfg["train"]["N_rand"])
    return mfu(run, flops)
