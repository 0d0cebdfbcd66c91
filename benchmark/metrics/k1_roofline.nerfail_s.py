"""K1's bound (the bytes of every batch's splat backward,
`counts.attack.k1_bytes`, at the memory bandwidth) over K1's device time
in the traced epoch, in percent."""

from benchmark.metrics.common import roofline

K1 = ("segsum_c4_kernel", "segsum_kernel")


def read(run):
    nbytes = run.stats.get("k1_bytes", 0)
    if nbytes <= 0:
        return None
    return roofline(run, K1, 0.0, nbytes)
