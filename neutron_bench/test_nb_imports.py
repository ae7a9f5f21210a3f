"""Nothing the benchmark runs imports JAX, flax, the JAX package
(``repro``) or its benchmarks, compared by whole top-level names (the
port's ``repro_torch`` begins with ``repro``); the reference imports
nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from neutron_bench.harness.env import FORBIDDEN

BENCH = Path(__file__).resolve().parent
SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts
                 and not p.name.startswith("test_nb_")
                 and p.name != "conftest.py")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in tops


def test_whole_name_comparison():
    from neutron_bench.harness import env
    assert env.forbidden_loaded({"repro_torch": 0, "repro_torch.api": 0,
                                 "numpy": 0}) == []
    assert env.forbidden_loaded({"repro.core": 0, "jaxlib.xla": 0,
                                 "benchmarks": 0}) == [
        "benchmarks", "jaxlib", "repro"]


def test_a_run_loads_none_of_them():
    """A whole run on the CPU in a fresh process: the run itself exits 3
    when one of them is loaded once its window has closed."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "sys.path[:0] = ['src', '.']\n"
        "from neutron_bench import run\n"
        "from neutron_bench.harness import cells\n"
        "cfg = dict(cells.config('mobilenet_v2-int8'), resolution=32)\n"
        "rc = run.main(['--workload', 'mobilenet_v2-int8.closed-b32', "
        "'--seed', '5', '--seconds', '0.5', '--trace', '0'], "
        "require_cuda=False, device='cpu', config=cfg, pool=64)\n"
        "from neutron_bench.harness import env\n"
        "print('FORBIDDEN', env.forbidden_loaded(), 'RC', rc)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                       capture_output=True, text=True, timeout=600)
    assert "FORBIDDEN [] RC 0" in p.stdout, p.stderr[-2000:]
