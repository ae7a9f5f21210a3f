"""Versioned on-disk artifact format for
:class:`repro_torch.api.CompiledModel`.

A deployment artifact is everything a serving process needs to run a
compiled workload *without recompiling*: the annotated graph (dtypes +
qparams), the timed NPU program, the tiling and bank allocation, the
execution weights (float originals plus the integer weight bundle for
quantized programs) and the resolved execution-semantics metadata.

The container is the checksummed zip of
:mod:`repro_torch.core.serialize`;
this module adds the model-level payloads and the **staleness contract**:
an artifact records the ``(Graph.fingerprint, NPUConfig,
CompilerOptions)`` key it was compiled under, and loading re-derives the
fingerprint from the embedded graph and re-validates every expectation
the caller supplies — a stale or mismatched artifact raises
:class:`~repro_torch.core.serialize.ArtifactError`, it is never silently
replayed.

Copy of the JAX package's ``api/artifact.py``: the two packages write the
same bytes for the same model and read each other's artifacts.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import serialize
from repro_torch.core.ir import Graph
from repro_torch.core.npu import NPUConfig
from repro_torch.core.pipeline import CompileResult, CompilerOptions
from repro_torch.core.serialize import ArtifactError

#: file extension for CompiledModel artifacts ("repro program artifact").
ARTIFACT_SUFFIX = ".rpa"


def options_to_payload(opts: CompilerOptions) -> dict:
    d = {f.name: getattr(opts, f.name) for f in fields(opts)}
    d["formats"] = list(d["formats"])
    return d


def options_from_payload(p: dict) -> CompilerOptions:
    kw = dict(p)
    kw["formats"] = tuple(kw["formats"])
    return CompilerOptions(**kw)


def save_model(path: str, *, name: str, graph: Graph, cfg: NPUConfig,
               options: CompilerOptions, result: CompileResult,
               weights: Dict[str, np.ndarray], precision: str,
               quant_meta: Optional[dict] = None,
               qweights: Optional[Dict[str, np.ndarray]] = None,
               packed: Optional[Dict[str, np.ndarray]] = None,
               calib_error: Optional[Dict[str, float]] = None,
               plan_consts: Optional[Dict[str, np.ndarray]] = None
               ) -> None:
    graph_payload, arrays = serialize.graph_to_payload(graph)
    for wname, arr in weights.items():
        arrays[f"wf/{wname}"] = np.asarray(arr)
    for wname, arr in (qweights or {}).items():
        arrays[f"qw/{wname}"] = np.asarray(arr)
    for wname, arr in (packed or {}).items():
        arrays[f"pk/{wname}"] = np.asarray(arr)
    # lowered-plan kernel constants (version 3): stored under indexed
    # member names (const keys hold step labels with ':'/'@'/'[') with
    # the key order in a payload, so loaders rebuild the exact store
    pl_keys = sorted(plan_consts or ())
    for i, ckey in enumerate(pl_keys):
        arrays[f"pl/{i:04d}"] = np.asarray(plan_consts[ckey])
    key = {
        "kind": "compiled-model",
        "fingerprint": graph.fingerprint(),
        "cfg": serialize.config_to_payload(cfg),
        "opts": serialize.options_digest(options.cache_key()),
        "precision": precision,
        "name": name,
    }
    payloads = {
        "model": {
            "name": name,
            "precision": precision,
            "options": options_to_payload(options),
            "quant": quant_meta,
            "calib_error": calib_error or {},
        },
        "graph": graph_payload,
        "program": serialize.program_to_payload(result.program),
        "plan": serialize.plan_to_payload(result.plan),
        "tiling": serialize.tiling_to_payload(result.tiling),
        "allocation": serialize.allocation_to_payload(result.allocation),
    }
    if pl_keys:
        payloads["planconsts"] = {"keys": pl_keys}
    serialize.write_artifact(path, key, payloads, arrays)


def load_model(path: str, *,
               expect_graph: Optional[Graph] = None,
               expect_cfg: Optional[NPUConfig] = None,
               expect_options: Optional[CompilerOptions] = None,
               mmap: bool = False
               ) -> Tuple[dict, Graph, NPUConfig, CompilerOptions,
                          CompileResult, Dict[str, np.ndarray],
                          Dict[str, np.ndarray], Dict[str, np.ndarray],
                          Optional[Dict[str, np.ndarray]]]:
    """Load + validate a CompiledModel artifact.

    Returns ``(model_payload, graph, cfg, options, result, weights,
    qweights, packed, plan_consts)`` — ``plan_consts`` maps lowering
    const keys to their persisted arrays (version-3 artifacts), or None
    when the artifact predates them.  Validation: container integrity
    (checksums,
    version) via :func:`repro_torch.core.serialize.read_artifact`, then the
    embedded graph's *recomputed* fingerprint must equal the stored key
    (catches hand-edits and fingerprint-algorithm drift), then any
    ``expect_*`` the caller passes must match the key (catches serving a
    program compiled for a different model/config/options).

    ``mmap=True`` maps weight arrays copy-on-write out of the (stored,
    version-2) artifact instead of materializing them in RAM; the
    sha256 manifest is still fully validated either way.
    """
    key, payloads, arrays = serialize.read_artifact(path,
                                                    mmap_arrays=mmap)
    if key.get("kind") != "compiled-model":
        raise ArtifactError(
            f"{path}: artifact kind {key.get('kind')!r} is not a "
            f"compiled model")
    graph = serialize.graph_from_payload(payloads["graph"], arrays)
    fp = graph.fingerprint()
    if fp != key.get("fingerprint"):
        raise ArtifactError(
            f"{path}: stale artifact — embedded graph fingerprint "
            f"{fp[:12]}… does not match stored key "
            f"{str(key.get('fingerprint'))[:12]}…")
    cfg = serialize.config_from_payload(key["cfg"])
    options = options_from_payload(payloads["model"]["options"])
    if serialize.options_digest(options.cache_key()) != key.get("opts"):
        raise ArtifactError(
            f"{path}: stale artifact — stored options do not match key")
    if expect_graph is not None and expect_graph.fingerprint() != fp:
        raise ArtifactError(
            f"{path}: artifact was compiled for a different graph "
            f"(stale for {expect_graph.name!r})")
    if expect_cfg is not None and expect_cfg != cfg:
        raise ArtifactError(
            f"{path}: artifact was compiled for config "
            f"{cfg.name!r}, not {expect_cfg.name!r}")
    if expect_options is not None and \
            expect_options.cache_key() != options.cache_key():
        raise ArtifactError(
            f"{path}: artifact was compiled under different options")
    result = CompileResult(
        serialize.program_from_payload(payloads["program"]),
        serialize.plan_from_payload(payloads["plan"]),
        serialize.tiling_from_payload(payloads["tiling"]),
        serialize.allocation_from_payload(payloads["allocation"]),
        compile_s=0.0, phase_s={}, cache_hit=True, cache_key=fp,
        cache_tier="artifact")
    weights = {k[3:]: arrays[k] for k in arrays if k.startswith("wf/")}
    qweights = {k[3:]: arrays[k] for k in arrays if k.startswith("qw/")}
    packed = {k[3:]: arrays[k] for k in arrays if k.startswith("pk/")}
    plan_consts = None
    pc = payloads.get("planconsts")
    if pc is not None:
        try:
            plan_consts = {ckey: arrays[f"pl/{i:04d}"]
                           for i, ckey in enumerate(pc["keys"])}
        except KeyError as e:
            raise ArtifactError(
                f"{path}: planconsts key index references missing "
                f"array member ({e})") from None
    return (payloads["model"], graph, cfg, options, result,
            weights, qweights, packed, plan_consts)
