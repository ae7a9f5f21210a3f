"""Carry a quantized model of the JAX package across to the port.

The port never imports the JAX package, so a quantized model crosses as
numpy arrays: per tensor its qparams ``(scale, zero_point, bits, axis)``
and the stored integer weights.  :func:`quantized_from_numpy` annotates
the port's own graph of the same model with them, as ``quantize_graph``
would, and refuses unless the annotated graph's fingerprint is the
reference's.  The tests use it to replay the port's plan on exactly the
reference's quantized model, independent of the port's PTQ.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.ir import Graph, QParams

from .ptq import QuantizedModel
from .qparams import pack_int4

QParamsArrays = Tuple[np.ndarray, np.ndarray, int, Optional[int]]


def qparams_to_numpy(g) -> Dict[str, QParamsArrays]:
    """The ``(scale, zero_point, bits, axis)`` of every annotated tensor
    of a quantized graph (of either package)."""
    return {t.name: (np.asarray(t.qparams.scale),
                     np.asarray(t.qparams.zero_point),
                     int(t.qparams.bits), t.qparams.axis)
            for t in g.tensors.values() if t.qparams is not None}


def _dtype(t, bits: int) -> str:
    if not t.is_param:
        return "int8"
    return {32: "int32", 8: "int8", 4: "int4"}[bits]


def quantized_from_numpy(graph: Graph, qparams: Dict[str, QParamsArrays],
                         qweights: Dict[str, np.ndarray], fingerprint: str,
                         weights_f: Optional[Dict[str, np.ndarray]] = None,
                         calib_error: Optional[Dict[str, float]] = None
                         ) -> QuantizedModel:
    """Annotate ``graph`` (float32, built by the port) in place with the
    given qparams and return the port's :class:`QuantizedModel`.

    ``fingerprint`` is the reference's quantized graph fingerprint;
    ``weights_f`` the float weights (for the float oracle) and
    ``calib_error`` the reference's ``QuantizedModel.calib_error`` (the
    basis of ``float_tolerance``).  Raises ValueError when a name is
    unknown or the fingerprints differ."""
    unknown = sorted(set(qparams) - set(graph.tensors))
    if unknown:
        raise ValueError(f"qparams name tensors the graph lacks: "
                         f"{unknown[:5]}")
    missing = sorted(set(qweights) - set(graph.tensors))
    if missing:
        raise ValueError(f"qweights name tensors the graph lacks: "
                         f"{missing[:5]}")
    wbits = 8
    for name, (scale, zp, bits, axis) in qparams.items():
        t = graph.tensors[name]
        if axis is None:
            qp = QParams(np.float32(scale), np.int64(zp), bits=int(bits))
        else:
            qp = QParams(np.asarray(scale, np.float32),
                         np.asarray(zp, np.int64), bits=int(bits),
                         axis=int(axis))
        t.qparams = qp
        t.dtype = _dtype(t, int(bits))
        if t.is_param and bits < 32:
            wbits = int(bits)
    got = graph.fingerprint()
    if got != fingerprint:
        raise ValueError(f"graph {graph.name}: fingerprint {got[:12]} after "
                         f"annotation differs from the reference's "
                         f"{fingerprint[:12]}")
    qw = {k: np.asarray(v) for k, v in qweights.items()}
    weight_dtype = "int4" if wbits == 4 else "int8"
    packed = {}
    if weight_dtype == "int4":
        packed = {k: pack_int4(v) for k, v in qw.items()
                  if graph.tensors[k].dtype == "int4"}
    return QuantizedModel(graph, qw, packed, dict(weights_f or {}),
                          weight_dtype, dict(calib_error or {}))
