"""Mean time a window's batch spends settling its tickets after its
``batch`` span (the program's ``settle`` spans: each ticket fulfilled
with its callbacks, the latency histogram), in ms."""
from neutron_bench.metrics._phases import ms_per_batch

UNIT = "ms"


def read(run):
    return ms_per_batch(run, ("settle",))
