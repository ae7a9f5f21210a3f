"""Mean time a window's batch spends handing its outputs back (the
program's ``copy_back`` spans: the device-to-host copies, which first
wait for the batch's last kernels), in ms."""
from neutron_bench.metrics._phases import ms_per_batch

UNIT = "ms"


def read(run):
    return ms_per_batch(run, ("copy_back",))
