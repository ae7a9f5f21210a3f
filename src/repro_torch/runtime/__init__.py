"""The serving runtime of the port (counterpart of ``repro/runtime``).

* ``serving`` — typed request errors, ``Ticket``, ``CircuitBreaker`` and
  the thread ``ServerPool``, whose workers each run their batches on a
  CUDA stream of their own;
* ``fault`` — heartbeats and the failure monitor the pool supervises
  with (a copy);
* ``chaos`` — fault injection for tests and ``chip_smoke.py`` (a copy);
* ``procpool`` — the process pool: each worker a spawned OS process with
  its own CUDA context, the CRC-framed pipe protocol, crash and frame
  re-dispatch;
* ``fleet`` — replica sessions behind one health-routed, hedged
  ``submit()``, with failover, the silent-corruption auditor, canary-gated
  rolling updates and rebalancing;
* ``overlap`` — the training step's microbatched gradient accumulation.
"""
