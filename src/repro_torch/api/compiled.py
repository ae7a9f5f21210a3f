"""The deployable unit of the ``repro_torch.api`` surface.

Counterpart of ``repro/api/compiled.py``.  A :class:`CompiledModel` is
one workload compiled once for the modeled Neutron NPU, bundled with
everything needed to execute it: the timed
:class:`~repro_torch.core.program.NPUProgram`, the tiling, the bank
allocation, the (integer or float) weights, the resolved execution
semantics and the torch device it replays on:

    model = repro_torch.api.compile("mobilenet_v2", precision="int8")
    logits = model(image)                   # single (H, W, C) input
    batch = model(images)                   # (B, H, W, C) batch
    model.save("mnv2.rpa")
    model = CompiledModel.load("mnv2.rpa", mmap=True)   # no recompile

Requests are served by the device plan (:mod:`repro_torch.core.execplan`,
every conv and fc on K1: the int8 plan contract for int8 models, the
float32 Pallas contract for float32 ones), and outputs come back as
tensors on the model's device.  The plan cache is safe across threads:
however many serving workers ask at once, a model lowers its steps (and
uploads its constants) once.  The interpretive executor
(:mod:`repro_torch.core.executor`, numpy on the host) is the validating
oracle, reached only with ``engine="interp"``, ``check=True`` or
:meth:`CompiledModel.verify`.  Artifacts are the reference's format, byte
for byte: a model saved by either package loads in the other.
"""
from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.execplan import (ExecPlan, PlanConsts, lower_plan,
                                       lower_steps)
from repro_torch.core.executor import (ExecSemantics, ExecutionError,
                                       ExecutionReport, FLOAT_SEMANTICS,
                                       execute)
from repro_torch.core.ir import Graph, graph_precision
from repro_torch.core.npu import NPUConfig
from repro_torch.core.pipeline import CompileResult, CompilerOptions
from repro_torch.obs import trace as _trace

from . import artifact as _artifact

Inputs = Union[np.ndarray, torch.Tensor, Dict[str, object]]
Outputs = Dict[str, torch.Tensor]

#: batch-size buckets compiled replay plans are built for.  A request
#: batch is served by the smallest bucket that fits it (ragged tails
#: just run the bucket partially full); batches past the largest bucket
#: are chunked.
PLAN_BUCKETS = (1, 2, 4, 8, 16, 32)


def resolve_semantics(graph: Graph, qm=None,
                      sem_meta: Optional[dict] = None
                      ) -> Optional[ExecSemantics]:
    """Execution semantics implied by a graph's precision annotation
    (plus, for quantized graphs, the integer-weight bundle and any
    persisted semantics metadata).  A dtype-cast graph with no qparams
    anywhere (``repro_torch.quant.cast_graph`` — the cost-model-only
    annotation) has *no* executable semantics and resolves to None."""
    if graph_precision(graph) == "float32":
        return FLOAT_SEMANTICS
    if qm is None:
        if not any(t.qparams is not None for t in graph.tensors.values()):
            return None               # cast-only: latency model, no replay
        raise ValueError(
            f"graph {graph.name!r} is quantized but no QuantizedModel "
            f"bundle was provided")
    from repro_torch.quant import QuantSemantics
    if sem_meta:
        return QuantSemantics.from_meta(qm, sem_meta)
    return QuantSemantics(qm)


def _host(arr) -> np.ndarray:
    """A request value as the interpreter's numpy array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _stack(vals: list):
    """Single-sample values stacked along a new batch axis: numpy when
    every value is numpy (the plan copies the batch to the device once),
    else tensors on the first tensor's device."""
    tensors = [v for v in vals if isinstance(v, torch.Tensor)]
    if not tensors:
        return np.stack([np.asarray(v) for v in vals])
    dev = tensors[0].device
    return torch.stack([torch.as_tensor(v).to(dev) for v in vals])


@dataclass
class CompiledModel:
    """A compiled, executable, persistable NPU workload."""

    name: str
    graph: Graph
    cfg: NPUConfig
    options: CompilerOptions
    result: CompileResult
    weights: Dict[str, np.ndarray]           # float execution weights
    semantics: ExecSemantics = field(default=FLOAT_SEMANTICS, repr=False)
    qm: Optional[object] = field(default=None, repr=False)  # QuantizedModel
    source: str = "compile"                  # "compile" | "cache" | path
    #: the quant.CalibrationTable a PTQ-inside compile derived (reusable
    #: via api.compile(..., calibration=...); not persisted in artifacts)
    calibration: Optional[dict] = field(default=None, repr=False)
    #: the device the plans replay on and outputs come back on: CUDA
    #: unless the caller asks for the CPU (``resolve_device``)
    device: Optional[torch.device] = None
    #: lazily built compiled replay plans, keyed by
    #: (graph fingerprint, semantics dtype, batch bucket, owner)
    _plans: Dict[tuple, ExecPlan] = field(default_factory=dict, repr=False)
    #: get-or-compute store for the lowering-time kernel constants (host
    #: numpy arrays); artifacts persist it so loaded models serve the
    #: derived arrays (memory-mapped) instead of recomputing them
    _plan_consts: Optional[PlanConsts] = field(default=None, repr=False)
    _plan_stats: Dict[str, float] = field(
        default_factory=lambda: {"builds": 0, "hits": 0, "build_s": 0.0,
                                 "plan_requests": 0, "plan_batches": 0},
        repr=False)
    #: the one step lowering shared by every plan: (steps, ids,
    #: granularity), with the device constants the steps hold
    _lowered: Optional[tuple] = field(default=None, repr=False)
    #: guards _lowered, _plans, _plan_consts and _plan_stats: serving
    #: workers ask for plans from several threads
    _lock: threading.RLock = field(default_factory=threading.RLock,
                                   repr=False, compare=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    # -- structure ----------------------------------------------------------
    @property
    def program(self):
        return self.result.program

    @property
    def tiling(self):
        return self.result.tiling

    @property
    def allocation(self):
        return self.result.allocation

    @property
    def plan(self):
        return self.result.plan

    @property
    def precision(self) -> str:
        if self.semantics is None:    # dtype-cast, cost-model-only
            return graph_precision(self.graph)
        return self.semantics.name

    @property
    def fingerprint(self) -> str:
        fp = self.result.cache_key
        if fp is None:
            fp = getattr(self, "_fp_memo", None)
            if fp is None:    # hash once — this sits on the request path
                fp = self._fp_memo = self.graph.fingerprint()
        return fp

    @property
    def compile_s(self) -> float:
        return self.result.compile_s

    @property
    def cache_tier(self) -> Optional[str]:
        return self.result.cache_tier

    # -- execution ----------------------------------------------------------
    def _normalize(self, inputs: Inputs) -> Dict[str, object]:
        if isinstance(inputs, (np.ndarray, torch.Tensor)):
            ins = self.graph.inputs
            if len(ins) != 1:
                raise ValueError(
                    f"{self.name}: graph has {len(ins)} inputs — pass a "
                    f"dict of name -> array")
            return {ins[0].name: inputs}
        return dict(inputs)

    def _batch_size(self, feed: Dict[str, object]) -> Optional[int]:
        sizes = set()
        for t in self.graph.inputs:
            arr = feed[t.name]
            shape = tuple(arr.shape) if isinstance(arr, torch.Tensor) \
                else np.shape(arr)
            if len(shape) == len(t.shape) + 1 and shape[1:] == t.shape:
                sizes.add(shape[0])
            elif shape != t.shape:
                raise ValueError(
                    f"{self.name}: input {t.name} has shape {shape}, "
                    f"expected {t.shape} or (B, *{t.shape})")
        if len(sizes) > 1:
            raise ValueError(f"{self.name}: inconsistent batch sizes "
                             f"{sorted(sizes)}")
        return sizes.pop() if sizes else None

    def _require_semantics(self) -> None:
        if self.semantics is None:
            raise RuntimeError(
                f"{self.name}: compiled from a dtype-cast graph "
                f"(cost-model-only) — no executable semantics")

    def _on_device(self, outs: Dict[str, np.ndarray]) -> Outputs:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in outs.items()}

    def _run_one(self, feed: Dict[str, object],
                 check: bool) -> Dict[str, np.ndarray]:
        """One sample through the interpretive executor (host, numpy);
        decoded outputs as numpy arrays."""
        self._require_semantics()
        rep = execute(self.program, self.graph, self.tiling,
                      {k: _host(v) for k, v in feed.items()},
                      self.weights, check=check,
                      semantics=self.semantics)
        if check:
            return rep.outputs       # already decoded + oracle-verified
        return {name: self.semantics.decode(name, arr)
                for name, arr in rep.outputs.items()}

    # -- compiled replay plans ---------------------------------------------
    def plan_for(self, batch: int = 1, owner=None) -> ExecPlan:
        """The compiled replay plan on the model's device serving a
        ``batch``-request group: lowered lazily, cached per batch-size
        bucket (and per execution dtype — the graph fingerprint is part
        of the key).  Step lowering — with its device weight constants —
        runs once per model (:meth:`lower`) and is shared across buckets;
        only the arena is per-bucket.

        ``owner`` keys an additional arena dimension: a plan's arena is
        single-threaded state, so each serving-pool worker passes its
        worker id to get its *own* arena (allocated on the worker's
        stream) while still sharing the one-time step lowering with every
        other worker.  One lock covers the lowering and the cache."""
        self._require_semantics()
        bucket = next((b for b in PLAN_BUCKETS if b >= batch),
                      PLAN_BUCKETS[-1])
        key = (self.fingerprint, self.semantics.name, bucket, owner)
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plan_stats["hits"] += 1
                return plan
            plan = lower_plan(self.program, self.graph, self.tiling,
                              self.weights, self.semantics,
                              capacity=bucket, lowered=self.lower(),
                              device=self.device)
            self._plans[key] = plan
            self._plan_stats["builds"] += 1
            self._plan_stats["build_s"] += plan.build_s
            return plan

    def lower(self) -> tuple:
        """Lower the model's steps onto its device once (idempotent):
        the constants are derived (or served from the artifact's store)
        and uploaded here.  A serving session calls this when a model is
        added, so that no worker's first batch pays for it."""
        self._require_semantics()
        with self._lock:
            if self._lowered is None:
                t0 = _time.monotonic()
                if self._plan_consts is None:
                    self._plan_consts = PlanConsts()
                self._lowered = lower_steps(self.program, self.graph,
                                            self.tiling, self.weights,
                                            self.semantics,
                                            consts=self._plan_consts,
                                            device=self.device)
                self._plan_stats["build_s"] += _time.monotonic() - t0
            return self._lowered

    def invalidate_plans(self) -> None:
        """Drop every cached replay plan, the shared lowered step list
        *and* the kernel-constant store, forcing a fresh re-lower from
        the raw weights on the next request.  The serving runtime's
        circuit-breaker recovery calls this: if a plan (or its
        constants) went bad, the rebuilt one must not share any state
        with it.  Workers still running an old plan keep it alive until
        they finish."""
        with self._lock:
            self._plans.clear()
            self._lowered = None
            self._plan_consts = PlanConsts()

    def plan_cache_info(self) -> Dict[str, object]:
        with self._lock:
            info = dict(self._plan_stats)
            keys = list(self._plans)
            pc = self._plan_consts
        info["plans"] = sorted(
            (fp[:12], sem, bucket, "-" if owner is None else str(owner))
            for fp, sem, bucket, owner in keys)
        info["consts"] = len(pc) if pc is not None else 0
        info["consts_computed"] = pc.computed if pc is not None else 0
        info["consts_served"] = pc.served if pc is not None else 0
        return info

    def _run_plan_batch(self, stacked: Dict[str, object], n: int,
                        owner=None) -> Outputs:
        """Run ``n`` stacked requests through bucketed plans (chunking
        past the largest bucket)."""
        cap = PLAN_BUCKETS[-1]
        with self._lock:
            self._plan_stats["plan_requests"] += n
            self._plan_stats["plan_batches"] += -(-n // cap)
        if n <= cap:
            return self.plan_for(n, owner=owner).run(stacked, n=n)
        outs: Dict[str, list] = {}
        for i in range(0, n, cap):
            j = min(i + cap, n)
            chunk = {k: v[i:j] for k, v in stacked.items()}
            res = self.plan_for(j - i, owner=owner).run(chunk, n=j - i)
            for name, val in res.items():
                outs.setdefault(name, []).append(val)
        return {name: torch.cat(vals) for name, vals in outs.items()}

    def __call__(self, inputs: Inputs, check: bool = False,
                 engine: Optional[str] = None) -> Outputs:
        """Run the compiled model.  ``inputs`` is one array or tensor
        (single-input graphs), a dict of name -> array, or either with a
        leading batch axis.  Returns float32 tensors on the model's
        device.

        Requests are served by the **compiled replay plan** on the
        device (lowered once, batch-vectorized; see
        :mod:`repro_torch.core.execplan`), whose stored integers match
        the interpretive executor's for int8/int4.  Pass
        ``engine="interp"`` to force the interpretive (validating)
        executor on the host; ``check=True`` implies it and additionally
        verifies every output against the functional oracle, per
        sample."""
        feed = self._normalize(inputs)
        batch = self._batch_size(feed)
        if engine is None:
            engine = "interp" if check else "plan"
        if engine not in ("plan", "interp"):
            raise ValueError(f"engine must be 'plan'/'interp', "
                             f"got {engine!r}")
        if check and engine == "plan":
            raise ValueError(
                "check=True runs the interpretive oracle path — use "
                "verify() to cross-check the plan against it")
        if engine == "plan":
            self._require_semantics()
            if batch is None:
                return self.plan_for(1).run(feed)    # unbatched shapes
            return self._run_plan_batch(feed, batch)
        if batch is None:
            return self._on_device(self._run_one(feed, check))
        outs: Dict[str, list] = {}
        for i in range(batch):
            sample = {}
            for t in self.graph.inputs:
                arr = feed[t.name]
                sample[t.name] = arr[i] if len(arr.shape) == \
                    len(t.shape) + 1 else arr
            res = self._run_one(sample, check)
            for name, val in res.items():
                outs.setdefault(name, []).append(val)
        return self._on_device({name: np.stack(vals)
                                for name, vals in outs.items()})

    def run_many(self, requests: List[Inputs], check: bool = False,
                 owner=None) -> List[Outputs]:
        """Execute a group of independent requests as one (or a few)
        batched plan replays; returns one output dict per request in
        order, tensors on the model's device.  ``check=True`` falls back
        to per-sample interpretive oracle replay.  ``owner`` selects a
        per-caller plan arena (see :meth:`plan_for`)."""
        if not requests:
            return []
        if check:
            return [self._on_device(self._run_one(f, True))
                    for f in self._single_samples(requests)]
        res = self.run_batch(requests, owner=owner)
        return [{name: vals[i] for name, vals in res.items()}
                for i in range(len(requests))]

    def _single_samples(self, requests: List[Inputs]
                        ) -> List[Dict[str, object]]:
        feeds = [self._normalize(r) for r in requests]
        for f in feeds:
            if self._batch_size(f) is not None:
                raise ValueError(
                    f"{self.name}: run_many takes single-sample requests"
                    f" — pass a batched array to __call__ instead")
        return feeds

    def run_batch(self, requests: List[Inputs], owner=None) -> Outputs:
        """Stack a group of single-sample requests and replay them
        through the plans (one copy of the batch to the device); returns
        each output batched, ``(len(requests), *shape)`` on the model's
        device.  The serving session copies these to the host once per
        batch."""
        tracer = _trace.active()
        if tracer is not None:
            phase = tracer.phase("stage.stack")
        feeds = self._single_samples(requests)
        self._require_semantics()
        stacked = {t.name: _stack([f[t.name] for f in feeds])
                   for t in self.graph.inputs}
        if tracer is not None:
            phase.end()
        return self._run_plan_batch(stacked, len(feeds), owner=owner)

    def verify(self, inputs: Inputs) -> ExecutionReport:
        """Checked single-sample replay exercising **both** execution
        paths: the interpretive executor replays on the host against the
        functional oracle (residency/persistency/bank invariants
        included), then the device plan runs the same sample and its
        decoded outputs are held against the interpreter's within
        ``plan_parity_tol`` (one output quantization step for
        int8/int4)."""
        feed = self._normalize(inputs)
        if self._batch_size(feed) is not None:
            raise ValueError("verify() takes a single (unbatched) sample")
        host = {k: _host(v) for k, v in feed.items()}
        rep = execute(self.program, self.graph, self.tiling, host,
                      self.weights, check=True, semantics=self.semantics)
        plan_out = self.plan_for(1).run(host)
        for t in self.graph.outputs:
            got = plan_out[t.name].cpu().numpy()
            want = rep.outputs[t.name]
            err = float(np.max(np.abs(got - want))) if got.size else 0.0
            tol = self.semantics.plan_parity_tol(t.name, want)
            if err > tol:
                raise ExecutionError(
                    f"{self.name}: plan replay diverged from the "
                    f"interpretive executor on {t.name}: max|err|="
                    f"{err:.3e} (tol {tol:.3e})")
        return rep

    # -- reporting ----------------------------------------------------------
    def profile(self, inputs: Optional[Inputs] = None, batch: int = 8,
                runs: int = 3):
        """Modeled-vs-measured execution profile (a
        :class:`~repro_torch.obs.profile.ProfileReport`): one timed,
        per-step-instrumented plan replay on the model's device (CUDA
        events on the card), correlated per op with the cost model's
        cycles."""
        from repro_torch.obs.profile import profile_model
        self._require_semantics()
        return profile_model(self, inputs, batch=batch, runs=runs)

    def stats(self) -> Dict[str, float]:
        s = self.result.stats()
        s["precision"] = self.precision
        s["fingerprint"] = self.fingerprint
        s["plan"] = self.plan_cache_info()
        return s

    def report(self) -> str:
        s = self.program.stats()
        ts = self.tiling.stats or {}
        fused = ts.get("fused_steps", 0)
        cov = f"{100.0 * ts.get('fused_steps_cp', 0) / fused:.0f}%" \
            if fused else "n/a (no fused regions)"
        lines = [
            f"CompiledModel {self.name!r}  [{self.precision}] on "
            f"{self.device}",
            f"  config       {self.cfg.name}  "
            f"({self.cfg.peak_tops:.1f} peak TOPS, "
            f"{self.cfg.tcm_bytes // 1024} KiB TCM / "
            f"{self.cfg.tcm_banks} banks)",
            f"  fingerprint  {self.fingerprint[:16]}…",
            f"  source       {self.source}"
            + (f" (cache tier: {self.cache_tier})" if self.cache_tier
               else ""),
            f"  compile      {self.result.compile_s * 1e3:.1f} ms",
            f"  program      {s['ticks']:.0f} ticks, "
            f"{s['gmacs']:.2f} GMACs, {s['ddr_mb']:.2f} MB DDR",
            # fusion coverage: how much of the fusion-eligible work the
            # CP actually optimized (the rest ran the greedy order)
            f"  fusion       {ts.get('cp_regions', 0)} CP + "
            f"{ts.get('windowed_regions', 0)} windowed "
            f"({ts.get('windows', 0)} windows) + "
            f"{ts.get('greedy_regions', 0)} greedy regions, "
            f"{ts.get('layerwise_regions', 0)} layer-wise; "
            f"optimized fused steps: {cov}",
            f"  latency      {s['latency_ms']:.3f} ms modeled "
            f"({s['effective_tops']:.2f} effective TOPS, "
            f"{100 * s['utilization']:.0f}% of peak)",
        ]
        ps = self._plan_stats
        if self._plans:
            buckets = sorted({b for (_, _, b, _) in self._plans})
            kernels = sum(len(p.steps) for p in self._plans.values())
            arena = max(p.arena_bytes for p in self._plans.values())
            lines.append(
                f"  replay       {len(self._plans)} plan(s), buckets "
                f"{buckets}, {kernels} kernels, arena "
                f"{arena / 1024:.0f} KiB/request, built in "
                f"{ps['build_s'] * 1e3:.1f} ms "
                f"({ps['plan_requests']:.0f} plan requests in "
                f"{ps['plan_batches']:.0f} batches)")
        else:
            lines.append("  replay       no plans built yet "
                         "(lowered lazily on first request)")
        return "\n".join(lines)

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the versioned on-disk artifact (everything needed to
        :meth:`load` and execute in another process, no recompile —
        including the lowered-plan kernel constants, so a loading
        process's first request serves them instead of re-deriving)."""
        if self.semantics is None:
            raise RuntimeError(
                f"{self.name}: cost-model-only models (dtype-cast "
                f"graphs) are not persistable deployment artifacts")
        if self._plan_consts is None or not len(self._plan_consts):
            self.lower()              # populate the constant store
        quant_meta = None
        qweights = packed = None
        calib_error = None
        if self.qm is not None:
            quant_meta = self.semantics.meta() \
                if hasattr(self.semantics, "meta") else None
            qweights = self.qm.qweights
            packed = self.qm.packed
            calib_error = self.qm.calib_error
        _artifact.save_model(
            path, name=self.name, graph=self.graph, cfg=self.cfg,
            options=self.options, result=self.result,
            weights=self.weights, precision=self.precision,
            quant_meta=quant_meta, qweights=qweights, packed=packed,
            calib_error=calib_error,
            plan_consts=self._plan_consts.as_arrays())
        return path

    @classmethod
    def load(cls, path: str, *,
             expect_graph: Optional[Graph] = None,
             expect_cfg: Optional[NPUConfig] = None,
             expect_options: Optional[CompilerOptions] = None,
             mmap: bool = False, device=None) -> "CompiledModel":
        """Load an artifact written by :meth:`save` (of either package)
        to replay on ``device`` (CUDA unless the caller asks for the
        CPU).  Integrity and staleness are validated (see
        :mod:`repro_torch.api.artifact`); a bad artifact raises
        :class:`repro_torch.core.serialize.ArtifactError`.  ``mmap=True``
        maps weights and plan constants copy-on-write out of the
        artifact."""
        device = resolve_device(device)
        (model_p, graph, cfg, options, result, weights, qweights,
         packed, plan_consts) = _artifact.load_model(
            path, expect_graph=expect_graph, expect_cfg=expect_cfg,
            expect_options=expect_options, mmap=mmap)
        qm = None
        sem_meta = model_p.get("quant")
        if model_p["precision"] != "float32":
            from repro_torch.quant import QuantizedModel
            qm = QuantizedModel(
                graph, qweights, packed, weights,
                weight_dtype=(sem_meta or {}).get("weight_dtype", "int8"),
                calib_error={k: float(v) for k, v in
                             (model_p.get("calib_error") or {}).items()})
        sem = resolve_semantics(graph, qm, sem_meta)
        return cls(model_p["name"], graph, cfg, options, result, weights,
                   semantics=sem, qm=qm, source=path, device=device,
                   _plan_consts=PlanConsts(plan_consts)
                   if plan_consts else None)
