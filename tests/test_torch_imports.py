"""Isolation of the PyTorch port: it imports neither ``jax`` nor the JAX
package, and its entry points never fall back to the CPU quietly."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PKG)], "repro_torch.")]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def test_importing_every_module_leaves_jax_and_repro_out():
    mods = _modules()
    assert "repro_torch.models.lm" in mods and len(mods) > 20
    assert {"repro_torch.obs.profile", "repro_torch.runtime.procpool",
            "repro_torch.runtime.fleet", "repro_torch.optim.adamw",
            "repro_torch.optim.schedules", "repro_torch.optim.compression",
            "repro_torch.runtime.overlap", "repro_torch.models.train",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
            "repro_torch.launch.train",
            "repro_torch.kernels.flash_attention_bwd"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from repro_torch.core.execplan import lower_plan
    from repro_torch.core.ir import GraphBuilder
    from repro_torch.launch.serve import serve
    from repro_torch.launch.serve_vision import serve_vision
    from repro_torch.models import lm
    from repro_torch.models.registry import get_arch
    from repro_torch.models.train import init_train_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("minitron-4b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("minitron-4b", batch=1, prompt_len=2, gen=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_vision("mobilenet_v2", batch=1, res_scale=0.25)
    b = GraphBuilder("g")
    b.mark_output(b.conv(b.input((4, 4, 3)), 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lower_plan(None, b.build(), None, {}, None)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository, the script fails and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
