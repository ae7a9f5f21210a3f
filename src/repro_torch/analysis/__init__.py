"""Cost and roofline of a step as the port runs it (the dry run's
analysis): ``cost`` counts what a step dispatches, ``roofline`` turns the
counts into the H100's three times."""
