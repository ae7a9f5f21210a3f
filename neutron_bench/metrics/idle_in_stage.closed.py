"""Share of the traced window in which the device is idle while the
host stages a batch's input (torch.profiler's idle intervals intersected
with the program's ``stage.*`` spans), in %."""
from neutron_bench.metrics._phases import STAGE, overlap_s, union

UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    staging = union((s[2], s[3]) for s in tr.spans
                    if s[0] in STAGE and s[1] == "serving")
    if not staging:
        return None
    return 100.0 * overlap_s(tr.gaps(), staging) / tr.window_s()
