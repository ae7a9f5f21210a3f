"""95th percentile (nearest rank) of the latency of every request due in
the window that did not fail, from when it was due to be sent to when
its ticket held the output."""
from neutron_bench.harness.trace import quantile

UNIT = "ms"


def read(run):
    lat = run.latencies_s()
    return quantile(lat, 0.95) * 1e3 if len(lat) else None
