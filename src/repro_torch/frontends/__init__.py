"""Model frontends of the port: the vision suite of paper Table IV
(``vision``), copied from ``repro/frontends``."""
