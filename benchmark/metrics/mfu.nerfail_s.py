"""The traced epoch's required FLOPs (`counts.attack.nerfail_s_view_flops`
per view and step) over the traced window, as a percentage of the fp32
peak (the classifier runs in fp32 with TF32 off)."""

from benchmark.counts import attack as counts


def read(run):
    s = run.summary
    views = run.stats.get("views", 0)
    if s is None or views <= 0 or s.window_s <= 0:
        return None
    flops = views * counts.nerfail_s_view_flops(run.cfg)
    return 100.0 * flops / s.window_s / run.peaks.fp32
