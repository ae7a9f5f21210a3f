"""``repro_torch.api`` — the deployment surface of the port.

Counterpart of ``repro.api``: a workload goes in once, a CP-optimized
program for the modeled Neutron NPU comes out (on the host, the port's
copy of the compiler), and its int8 or float32 plan replays on the GPU,
every conv and fc on the hand-written K1 kernel:

    import repro_torch.api as api

    model = api.compile("mobilenet_v2", precision="int8")  # PTQ inside
    out = model(images)                 # tensors on the model's device
    model.save("mnv2_int8.rpa")         # the reference's artifact format
    model = api.load("mnv2_int8.rpa", mmap=True)   # no recompile

    sess = api.Session(workers=2, max_batch=8)     # thread pool on CUDA
    sess.add(model, name="mnv2")
    ticket = sess.submit("mnv2", image)            # micro-batched
    ticket.result()                     # CPU tensors
    sess = api.Session(workers=("process", 2))     # one CUDA context each
    fleet = api.Session.fleet(replicas=2, workers=2)   # replicas, routed
    print(model.profile(batch=8))       # modeled vs measured, per op

    lm = api.DecodeSession(precision="int8")       # the tiny LM decoder
    rid, tok = lm.prefill([3, 17, 42])             # caches on the device
    toks = list(lm.stream(rid, max_new_tokens=16))

``compile`` accepts a benchmark model name, a ``Graph`` (+ weights), a
``(Graph, GraphBuilder)`` pair as returned by the frontends, or a
``QuantizedModel``, and resolves precision, options and execution
semantics.  Models replay on CUDA unless the caller passes
``device="cpu"``; with no GPU and no explicit device they raise.

``Session`` and the serving errors are exported as ``repro.api`` exports
them, with ``BreakerOpen``, the port's own (a CUDA session's open
breaker fails fast instead of serving from the host).
``DecodeSession`` (``api/decode.py``) serves the LM decoder of
``frontends/lm.py``: prefill on K2, every decode step's attention on K3,
every matmul on K1.  ``Fleet``, ``FleetError`` and ``UpdateRejected``
come from ``runtime/fleet.py``, as in ``repro.api``.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple, Union

from repro_torch import resolve_device
from repro_torch.core.ir import Graph, GraphBuilder, graph_precision
from repro_torch.core.npu import NEUTRON_2TOPS, NPUConfig
from repro_torch.core.pipeline import CompilerOptions, compile_graph
from repro_torch.core.serialize import ArtifactError

from repro_torch.runtime.serving import (BreakerOpen, Cancelled,
                                         CircuitBreaker,
                                         DeadlineExceeded, FlushError,
                                         FrameCorrupt, Overloaded,
                                         ServingError, Ticket, WorkerLost)

from .compiled import CompiledModel, resolve_semantics
from .decode import DecodeSession
from .session import Session

from repro_torch.runtime.fleet import Fleet, FleetError, UpdateRejected

__all__ = [
    "compile", "load", "CompiledModel", "Session", "DecodeSession",
    "ArtifactError",
    "CompilerOptions", "resolve_semantics",
    # serving robustness surface
    "ServingError", "Overloaded", "DeadlineExceeded", "FlushError",
    "WorkerLost", "Ticket", "CircuitBreaker", "Cancelled", "FrameCorrupt",
    "BreakerOpen",
    # fleet-level serving
    "Fleet", "FleetError", "UpdateRejected",
]

Source = Union[str, Graph, GraphBuilder, Tuple[Graph, GraphBuilder],
               "QuantizedModel"]  # noqa: F821


def _is_quantized_model(obj) -> bool:
    from repro_torch.quant import QuantizedModel
    return isinstance(obj, QuantizedModel)


def compile(graph_or_model: Source,                  # noqa: A001
            config: Optional[NPUConfig] = None,
            options: Optional[CompilerOptions] = None, *,
            weights=None,
            precision: str = "auto",
            res_scale: float = 1.0,
            calibration=None,
            calib_samples: int = 4,
            calib_method: str = "minmax",
            calib_percentile: float = 99.9,
            weight_dtype: str = "int8",
            seed: int = 0,
            cache: bool = True,
            name: Optional[str] = None,
            device=None) -> CompiledModel:
    """Compile one workload into a :class:`CompiledModel` that replays on
    ``device`` (CUDA unless the caller asks for the CPU).

    ``graph_or_model`` may be a benchmark model name
    (:data:`repro_torch.frontends.vision.VISION_MODELS`), a built
    ``Graph`` (pass ``weights`` to make the result executable), a
    ``(Graph, GraphBuilder)`` pair, a ``GraphBuilder``, or a
    ``QuantizedModel``.

    ``precision``:
      * ``"auto"``    — compile whatever the graph is annotated with;
      * ``"float32"`` — assert the graph is float32;
      * ``"int8"``    — run the full PTQ calibration flow internally
        (synthetic calibration set, min-max/percentile observers,
        per-channel int8/int4 weights) when the graph is still float32,
        then compile the quantized graph.

    ``calibration`` optionally supplies an existing
    ``quant.CalibrationTable`` (keyed by tensor name) so a re-quantize
    of the same model skips the float reference sweep; the table a
    compile derived is exposed as ``CompiledModel.calibration``.
    """
    if precision not in ("auto", "float32", "int8"):
        raise ValueError(f"precision must be auto/float32/int8, "
                         f"got {precision!r}")
    device = resolve_device(device)
    cfg = config or NEUTRON_2TOPS
    from repro_torch import quant

    qm = None
    g = None
    if isinstance(graph_or_model, str):
        from repro_torch.frontends import vision
        model_name = graph_or_model
        g, b = vision.build(model_name, res_scale=res_scale)
        weights = dict(b._weights)
        name = name or model_name
    elif _is_quantized_model(graph_or_model):
        qm = graph_or_model
        g = qm.graph
        weights = qm.weights_f
    elif isinstance(graph_or_model, tuple):
        g, b = graph_or_model
        weights = weights if weights is not None else dict(b._weights)
    elif isinstance(graph_or_model, GraphBuilder):
        b = graph_or_model
        g = b.g
        weights = weights if weights is not None else dict(b._weights)
    elif isinstance(graph_or_model, Graph):
        g = graph_or_model
        weights = dict(weights) if weights is not None else {}
    else:
        raise TypeError(
            f"cannot compile {type(graph_or_model).__name__}: expected a "
            f"model name, Graph, (Graph, GraphBuilder), GraphBuilder or "
            f"QuantizedModel")

    # PTQ-on-demand: int8 requested for a float graph -> calibrate inside
    calib_table = calibration
    if precision == "int8" and qm is None and \
            graph_precision(g) == "float32":
        if not weights:
            raise ValueError(
                f"precision='int8' on graph {g.name!r} needs weights to "
                f"run PTQ calibration")
        cal = quant.synthetic_calibration(g, samples=calib_samples,
                                          seed=seed)
        if calib_table is None:
            calib_table = quant.calibrate(g, weights, cal,
                                          method=calib_method,
                                          percentile=calib_percentile)
        qm = quant.quantize_graph(g, weights, calib_table,
                                  weight_dtype=weight_dtype)
        quant.measure_quant_error(qm, cal)

    opts = options or CompilerOptions()
    if precision != "auto" and opts.precision == "auto":
        opts = replace(opts, precision=precision)

    result = compile_graph(g, cfg, opts, cache=cache)
    sem = resolve_semantics(g, qm)
    src = "cache" if result.cache_hit else "compile"
    return CompiledModel(name or g.name, g, cfg, opts, result,
                         weights, semantics=sem, qm=qm, source=src,
                         calibration=calib_table, device=device)


def load(path: str, **kw) -> CompiledModel:
    """Load a saved artifact (alias for :meth:`CompiledModel.load`)."""
    return CompiledModel.load(path, **kw)
