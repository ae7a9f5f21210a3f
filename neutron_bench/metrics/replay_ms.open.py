"""Mean time of one batch in the window (the program's ``batch`` spans:
one replay through the compiled model, with its staging and copy back),
in ms."""
from neutron_bench.metrics._replay import replay_ms

UNIT = "ms"


def read(run):
    return replay_ms(run)
