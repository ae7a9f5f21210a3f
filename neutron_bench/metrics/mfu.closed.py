"""The whole replay's share of the H100's int8 dense peak, in %: 2 x the
network's multiply-adds an image (counted from its layer shapes) x the
images completed in the traced window, over the window, over 1979 TOP/s
(the frozen peak)."""
from neutron_bench.harness.frozen import PEAK_FLOPS

UNIT = "%"


def read(run):
    if run.trace is None:
        return None
    done = float(run.completed_in_window().sum())
    if not done:
        return None
    return 100.0 * 2.0 * run.macs_per_image * done / run.seconds \
        / PEAK_FLOPS["int8"]
