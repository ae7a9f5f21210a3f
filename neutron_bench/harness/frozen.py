"""The yardstick's constants and work counts, frozen here so that a change
to the program cannot move them.

Copied from the program as it stood when the benchmark was defined:
the H100's peaks from ``analysis/roofline.py`` (one NVIDIA H100 SXM5
80GB HBM3 at its 700 W power limit, NVIDIA's data sheet, dense rates)
and its ``bound``; K1's operation and byte counts from
``kernels/work.py`` (``matmul_flops``, ``nbytes``: each operand read once
and each output written once).
"""
from __future__ import annotations

from typing import Dict, Tuple

#: H100 SXM5 80GB HBM3 memory bandwidth, bytes a second
HBM_BYTES_S = 3.35e12
#: H100 SXM5 dense peak operations a second, by the rate of the operands
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "tf32": 495e12,
              "float32": 67e12}


def bound_s(nbytes: float, flops: Dict[str, float]) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the time to move
    ``nbytes`` through HBM and to do ``flops`` ({rate: operations}) at the
    H100's peaks."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(f / PEAK_FLOPS[r] for r, f in flops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matmul_flops_int8(rows: int, n: int, k: int) -> Dict[str, int]:
    """K1 over ``rows`` rows of ``k`` against ``n`` columns, int8."""
    return {"int8": 2 * rows * n * k}


def gemm_step_work(op_kind: str, in_shape, out_shape, wshape, batch: int,
                   bias: bool = True) -> Tuple[Dict[str, int], int]:
    """({rate: operations}, bytes) of one int8 conv or fc step of the
    plan at ``batch`` requests: the GEMM of (batch * oh * ow) rows of
    K = kh * kw * inC against outC columns; bytes are the int8 input
    activation, the int8 weight, the int32 bias and float32 rescale of
    each column, and the int8 output, each once."""
    oc = int(wshape[0])
    k = 1
    for d in wshape[1:]:
        k *= int(d)
    m = 1
    for d in out_shape[:-1]:
        m *= int(d)
    n_in = 1
    for d in in_shape:
        n_in *= int(d)
    n_out = m * oc
    nbytes = batch * n_in + oc * k + (4 * oc if bias else 0) + 4 * oc \
        + batch * n_out
    return matmul_flops_int8(batch * m, oc, k), nbytes
