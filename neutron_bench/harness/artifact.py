"""The compiled model a cell serves, as a deployment gets it: the
configuration's network with the benchmark's weights, quantized by the
program's PTQ on the benchmark's calibration images, compiled by
``repro_torch.api.compile`` and saved as an ``.rpa`` artifact.

The artifact is cached under ``neutron_bench/.cache/artifacts/``, keyed
by the configuration, the weight type, the device the weights were drawn
on, a hash of the program's sources and one of the harness's sources that
draw and bind its weights (the reference network among them), so the
first run of a cell in a checkout compiles and every later one loads.
The cache keeps at most ``CACHE_BYTES``, dropping the least recently used
artifacts first.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import data, env

CACHE_BYTES = 1 << 30


def program_hash() -> str:
    """sha256 over every source file of the program (``src/repro_torch``)."""
    h = hashlib.sha256()
    root = env.CHECKOUT / "src" / "repro_torch"
    for f in sorted(root.rglob("*")):
        if f.is_file() and f.suffix in (".py", ".cu", ".cuh", ".h"):
            h.update(str(f.relative_to(root)).encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def weights_hash(forward) -> str:
    """sha256 over the sources that draw and bind the weights: this file,
    ``data.py``, ``reference/qnet.py`` and the file ``forward`` is in."""
    from neutron_bench.reference import qnet
    h = hashlib.sha256()
    for f in (__file__, data.__file__, qnet.__file__,
              inspect.getsourcefile(forward)):
        h.update(Path(f).read_bytes())
    return h.hexdigest()


def key(cfg: Dict, forward, weight_dtype: str, device: torch.device) -> str:
    h = hashlib.sha256()
    h.update(json.dumps(cfg, sort_keys=True).encode())
    h.update(f"{weight_dtype}|{device.type}|{program_hash()}|"
             f"{weights_hash(forward)}".encode())
    return h.hexdigest()[:20]


def path_for(cfg: Dict, forward, weight_dtype: str,
             device: torch.device) -> Path:
    return env.ARTIFACTS / (f"{cfg['name']}-{weight_dtype}-"
                            f"{key(cfg, forward, weight_dtype, device)}.rpa")


def graph_of(cfg: Dict):
    """The program's graph of the configuration at its resolution."""
    from repro_torch.frontends import vision
    native = vision.VISION_MODELS[cfg["model"]][1]
    g, _ = vision.build(cfg["model"], res_scale=(cfg["resolution"] + 0.5)
                        / native)
    if g.inputs[0].shape != (cfg["resolution"], cfg["resolution"], 3):
        raise ValueError(f"{cfg['name']}: built {g.inputs[0].shape}")
    return g


def compile_model(cfg: Dict, forward, device: torch.device,
                  weight_dtype: str = "int8"):
    """PTQ and ``api.compile`` on the benchmark's weights and calibration
    images.  Returns the :class:`CompiledModel` (on ``device``)."""
    from repro_torch import api, quant
    from neutron_bench.reference.qnet import layer_specs

    g = graph_of(cfg)
    specs = layer_specs(forward, cfg["resolution"])
    params = data.draw_params(specs, cfg["weight_seed"], device)
    weights = data.bind_params(g, params, specs)
    missing = [t.name for t in g.tensors.values()
               if t.is_param and t.name not in weights]
    if missing:
        raise ValueError(f"{cfg['name']}: no weights for {missing[:4]}")
    calib = data.draw_images(cfg["weight_seed"], cfg["calib_images"],
                             cfg["resolution"], device, stream=1)
    cal = [{g.inputs[0].name: img} for img in calib.cpu().numpy()]
    table = quant.calibrate(g, weights, cal)
    qm = quant.quantize_graph(g, weights, table, weight_dtype=weight_dtype)
    quant.measure_quant_error(qm, cal)
    return api.compile(qm, precision="int8", device=device)


def ensure(cfg: Dict, forward, device: torch.device,
           weight_dtype: str = "int8") -> Dict:
    """The artifact's path, compiled and saved if the cache lacks it.
    Returns {"path", "compiled", "compile_s"}."""
    path = path_for(cfg, forward, weight_dtype, device)
    if path.exists():
        os.utime(path)
        return {"path": path, "compiled": False, "compile_s": 0.0}
    t0 = time.monotonic()
    model = compile_model(cfg, forward, device, weight_dtype)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    model.save(str(tmp))
    os.replace(tmp, path)
    del model
    _evict(keep=path)
    return {"path": path, "compiled": True,
            "compile_s": time.monotonic() - t0}


def _evict(keep: Path) -> None:
    files = sorted(env.ARTIFACTS.glob("*.rpa"),
                   key=lambda f: f.stat().st_mtime)
    total = sum(f.stat().st_size for f in files)
    for f in files:
        if total <= CACHE_BYTES:
            break
        if f != keep:
            total -= f.stat().st_size
            f.unlink(missing_ok=True)


def params_for(cfg: Dict, forward, device: torch.device):
    """(layer specs, float weights) of the configuration: what the
    reference is given."""
    from neutron_bench.reference.qnet import layer_specs
    specs = layer_specs(forward, cfg["resolution"])
    return specs, data.draw_params(specs, cfg["weight_seed"], device)


def calib_images(cfg: Dict, device: torch.device) -> torch.Tensor:
    return data.draw_images(cfg["weight_seed"], cfg["calib_images"],
                            cfg["resolution"], device, stream=1)


def host_images(seed: int, cfg: Dict, n: int,
                device: torch.device) -> np.ndarray:
    """A run's pool of request images, drawn on the device and held on
    the host as a client holds them."""
    return data.draw_images(seed, n, cfg["resolution"], device
                            ).cpu().numpy()
