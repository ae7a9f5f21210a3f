"""Images whose requests settled with an output inside the window, over
the window's length (a closed-loop cell's throughput)."""

UNIT = "images/s"


def read(run):
    return float(run.completed_in_window().sum()) / run.seconds
