"""Mean time a window's batch spends staging its input (the program's
``stage.stack``, ``stage.copy_in`` and ``stage.encode`` spans: stacking
the requests on the host, the copy to the device, the encode into the
plan's arena), in ms."""
from neutron_bench.metrics._phases import STAGE, ms_per_batch

UNIT = "ms"


def read(run):
    return ms_per_batch(run, STAGE)
