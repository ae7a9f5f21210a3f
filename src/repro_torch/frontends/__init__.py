"""Model frontends of the port, copied from ``repro/frontends``: the
vision suite of paper Table IV (``vision``) and the tiny LM decoder of
the causal-op decode path (``lm``)."""
