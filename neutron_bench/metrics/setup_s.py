"""Seconds from the process's start to the first timed request: imports,
CUDA's start, the kernels' build (loaded from the checkout's cache after
the first run), the artifact (compiled by the first run, loaded after),
the plan's lowering and the warm-up of every plan bucket."""

UNIT = "s"


def read(run):
    return run.setup_s
