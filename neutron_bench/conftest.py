"""Fixtures of the benchmark's own tests: runs of a cell on the CPU at a
small resolution (32), through the program's plain path."""
import io
import json
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = 32


@pytest.fixture
def cpu_run():
    """``cpu_run(cell, seed=..., seconds=..., trace=0, **kw)``: one run of
    the cell on the CPU at resolution 32; returns (exit code, stdout lines,
    stderr text)."""
    import torch
    torch.set_num_threads(2)
    from neutron_bench import run
    from neutron_bench.harness import cells

    def go(cell, seed=2_400_000_017, seconds=1.0, trace=0, **kw):
        wl = kw.pop("workload", None) or cells.workload(cell)
        cfg = dict(kw.pop("config", None) or cells.config(wl["config"]))
        cfg["resolution"] = TINY
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = run.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          require_cuda=False, device="cpu", workload=wl,
                          config=cfg, pool=64, check_imports=False, **kw)
        return rc, out.getvalue().splitlines(), err.getvalue()

    return go


def last_json(lines):
    return json.loads(lines[-1])
