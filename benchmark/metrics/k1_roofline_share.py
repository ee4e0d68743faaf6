"""K1's share of its roofline: the least time the card could take for the
window's dense sweeps over K1's device time in the trace, in %.

The work is the frozen roofline arithmetic (``benchmark/roofline.py``: 20
FP32 operations a segment and sphere) on the segments the reference's
paths took in the checked pixels, scaled to every path of the window, and
the scene's sphere count: counts the benchmark makes itself, never K1's
counters.  Bound by operations (the tables are a few tens of KB)."""
from benchmark import roofline

KERNEL = r"\bmega_kernel<false>"


def read(m):
    k1 = m["trace"].kernel_seconds(KERNEL)
    per_path = m["extras"].get("segments_per_path")
    if not k1 or not per_path:
        return None
    segments = per_path * m["stats"]["work"]
    ops = roofline.dense_ops(segments, m["arrays"]["sphere_center"].shape[0])
    return 100.0 * roofline.least_seconds(ops, 0.0) / k1
