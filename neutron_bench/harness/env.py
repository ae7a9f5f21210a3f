"""Where a run finds the program and keeps its caches.

Every cache lives at a fixed path inside the checkout, so that only the
first run of a cell in a checkout builds or compiles: the CUDA kernels in
``build/kernels`` (the program fixes that directory itself), and under
``neutron_bench/.cache/`` the compiled artifacts (``artifacts/``), the
program's compiled-program cache (``programs/``, through
``REPRO_PROGRAM_CACHE_DIR``), and the Triton, torch extension and CUDA
JIT caches, should anything use them.  Call :func:`prepare` before
torch is imported.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]          # neutron_bench/
CHECKOUT = BENCH.parent
CACHE = BENCH / ".cache"
ARTIFACTS = CACHE / "artifacts"

#: top-level module names that no run may load: the JAX package, JAX,
#: and the JAX package's own benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def prepare() -> None:
    """Put the program and the harness on ``sys.path`` and point every
    cache into the checkout."""
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    dirs = {"REPRO_PROGRAM_CACHE_DIR": CACHE / "programs",
            "TRITON_CACHE_DIR": CACHE / "triton",
            "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
            "CUDA_CACHE_PATH": CACHE / "cuda"}
    for var, path in dirs.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # no library may pull JAX in beside torch
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level modules in ``modules`` (``sys.modules``),
    each compared by its whole top-level name."""
    names = list(sys.modules if modules is None else modules)
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))
