"""Discovery by name: a cell's workload file, its configuration, the
traffic kind's generator, each metric's reader and the configuration's
reference network, each in a file named after it."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]          # neutron_bench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(kind: str, name: str) -> Dict:
    path = ROOT / kind / f"{_checked(name)}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def workload(name: str) -> Dict:
    """``workloads/<name>.json``: the configuration, the traffic (its
    ``kind`` and parameters), the session's settings and the metrics the
    cell reports."""
    return _json("workloads", name)


def config(name: str) -> Dict:
    """``configs/<name>.json``: the model as it is run."""
    return _json("configs", name)


_modules: Dict[str, ModuleType] = {}


def _module(kind: str, name: str) -> ModuleType:
    path = ROOT / kind / f"{_checked(name)}.py"
    key = f"neutron_bench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    mod = _modules.get(key)
    if mod is None:
        if not path.exists():
            raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return mod


def traffic(kind: str) -> ModuleType:
    """``traffic/<kind>.py``: the generator of one kind of traffic."""
    return _module("traffic", kind)


def metric(name: str) -> ModuleType:
    """``metrics/<name>.py``: ``UNIT`` and ``read(run) -> value or
    None``."""
    return _module("metrics", name)


def reference(config_name: str) -> ModuleType:
    """``reference/<config>.py``: ``forward(net, images)``."""
    return _module("reference", config_name)
