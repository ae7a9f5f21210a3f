"""Shared by the ``replay_ms`` readers: the window's ``batch`` spans
(the program's tracer: one batch through the compiled model, staging and
the copy back included), summed and divided by their number, in ms."""


def replay_ms(run):
    spans = run.batch_spans()
    if not spans:
        return None
    return sum(s[3] - s[2] for s in spans) / len(spans) * 1e3
