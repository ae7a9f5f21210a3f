"""Shared by the readers of a batch's host phases: the program's spans
``stage.stack``, ``stage.copy_in``, ``stage.encode``, ``decode``,
``copy_back`` and ``settle`` (category ``serving``), each
carrying its batch's id as ``batch``, as the ``batch`` span does.  The
window's batches are those whose ``batch`` span starts in the window.  A
program without these spans gives the readers nothing to read."""

#: the phases that stage a batch's input on the device
STAGE = ("stage.stack", "stage.copy_in", "stage.encode")


def _batch(span):
    return (span[5] or {}).get("batch")


def window_batches(run):
    """Ids of the window's batches (empty without a trace, or where the
    ``batch`` spans carry no id)."""
    spans = run.batch_spans() or []
    return {_batch(s) for s in spans} - {None}


def phase_spans(run, names, batches):
    """The spans named in ``names`` of the batches ``batches``."""
    return [s for s in run.trace.spans if s[0] in names
            and s[1] == "serving" and _batch(s) in batches]


def ms_per_batch(run, names):
    """Σ of the phases ``names`` over the window's batches ÷ their
    number, in ms."""
    batches = window_batches(run)
    spans = phase_spans(run, names, batches) if batches else []
    if not spans:
        return None
    return sum(s[3] - s[2] for s in spans) / len(batches) * 1e3


def union(intervals):
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_s(xs, ys):
    """Seconds inside both of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
