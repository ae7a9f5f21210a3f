"""Rate of the host-to-device copy of the window's batches: the bytes
the program's ``stage.copy_in`` spans count over their summed duration,
in GB/s (1e9 bytes)."""
from neutron_bench.metrics._phases import phase_spans, window_batches

UNIT = "GB/s"


def read(run):
    batches = window_batches(run)
    spans = phase_spans(run, ("stage.copy_in",), batches) if batches else []
    seconds = sum(s[3] - s[2] for s in spans)
    if seconds <= 0:
        return None
    return sum(s[5]["bytes"] for s in spans) / seconds / 1e9
