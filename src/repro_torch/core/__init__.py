"""The port's copy of the compiler IR (``ir``) and the device plan
replay engine (``execplan``).  Counterpart of ``repro/core``; the
compiler itself (tiling, scheduling, the CP solver, ``NPUProgram``) is
not ported yet (``ROADMAP.md`` item 6)."""
