"""The serving runtime of the port (counterpart of ``repro/runtime``).

* ``serving`` — typed request errors, ``Ticket``, ``CircuitBreaker`` and
  the thread ``ServerPool``, whose workers each run their batches on a
  CUDA stream of their own;
* ``fault`` — heartbeats and the failure monitor the pool supervises
  with (a copy);
* ``chaos`` — fault injection for tests and ``chip_smoke.py`` (a copy).

The process pool and ``Fleet`` (``procpool``, ``fleet``) are
``ROADMAP.md`` item 10.
"""
