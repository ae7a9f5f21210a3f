"""Quantization arithmetic: affine quantize/dequantize + int4 packing.

The :class:`repro_torch.core.ir.QParams` dataclass (scale, zero_point, bits,
per-channel axis) lives in the IR so graph fingerprints can include it;
this module supplies the arithmetic that gives it meaning:

  * ``quantize``/``dequantize`` — the affine map ``f = s * (q - z)`` with
    per-tensor or per-channel ``s``/``z`` broadcast along the channel
    axis;
  * ``qparams_from_range`` — scale/zero-point selection from an observed
    float range (symmetric for weights, asymmetric for activations —
    the standard TFLite/LiteRT PTQ convention the paper deploys);
  * ``pack_int4``/``unpack_int4`` — nibble packing for int4 weights: two
    signed 4-bit values per byte, low nibble first, flat row-major order
    (the storage format whose byte count ``Tensor.bytes`` charges).

Copy of the JAX package's ``quant/qparams.py`` (numpy only; the port imports
nothing of that package and keeps its own copy).  The tests hold it
equal to the original.  ``quantize_t``/``dequantize_t`` are the same
arithmetic on torch tensors, on the device the plan replays on.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ir import QParams

#: epsilon floor so a constant tensor still gets an invertible scale.
_MIN_SCALE = 1e-12


def _broadcast(qp: QParams, ndim: int) -> Tuple[np.ndarray, np.ndarray]:
    """scale/zero_point shaped to broadcast against an ndim-D array.

    Per-channel params broadcast along ``qp.axis``; per-tensor params are
    scalars already."""
    s = np.asarray(qp.scale, dtype=np.float32)
    z = np.asarray(qp.zero_point, dtype=np.int32)
    if qp.axis is None or s.ndim == 0:
        return s, z
    shape = [1] * ndim
    shape[qp.axis] = s.shape[0]
    return s.reshape(shape), z.reshape(shape)


def quantize(x: np.ndarray, qp: QParams) -> np.ndarray:
    """float -> stored integer values (int8 for bits<=8, int32 for bias).

    int4 values are clamped to [-8, 7] but *stored* one-per-int8 — the
    packed byte stream is produced separately by :func:`pack_int4` (and
    is what the DMA byte accounting charges)."""
    x = np.asarray(x, dtype=np.float32)
    s, z = _broadcast(qp, x.ndim)
    if s.ndim == 0:
        # per-tensor hot path: python scalars keep the whole pipeline in
        # float32 (a 0-d int32 zero point would promote the add — and
        # every pass after it — to float64).  Bit-identical: round(x/s)
        # is integer-valued, the add is exact below 2^24, and anything
        # past 2^24 is far outside the clip range either way.
        q = x / float(s)
        np.round(q, out=q)
        q += int(z)
        np.clip(q, qp.qmin, qp.qmax, out=q)
        return q.astype(np.int32 if qp.bits > 8 else np.int8)
    q = np.round(x / s) + z
    q = np.clip(q, qp.qmin, qp.qmax)
    return q.astype(np.int32 if qp.bits > 8 else np.int8)


def dequantize(q: np.ndarray, qp: QParams) -> np.ndarray:
    s, z = _broadcast(qp, np.asarray(q).ndim)
    return ((np.asarray(q, dtype=np.int64) - z) * s).astype(np.float32)


def device_scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d float32 tensor on ``like``'s device.

    Divide by this, never by a Python number: on CUDA, ATen turns a
    division by a CPU scalar into a multiply by its reciprocal, which
    differs from numpy's correctly rounded float32 division on about a
    quarter of all inputs; a division by a device tensor divides."""
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def _broadcast_t(qp: QParams, like: torch.Tensor):
    s, z = _broadcast(qp, like.dim())
    if s.ndim == 0:
        return device_scalar(s, like), int(z)
    return (torch.from_numpy(np.ascontiguousarray(s)).to(like.device),
            torch.from_numpy(np.ascontiguousarray(z)).to(like.device))


def quantize_t(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """:func:`quantize` on a tensor, on its device, bit for bit:
    ``round(x / s)`` in float32 (half to even), ``+ z``, clip, cast.  The
    per-channel form adds ``z`` in float32 where numpy promotes to
    float64; both hold the same integers below 2^24, and the clip maps
    anything larger to the same bound."""
    x = x.to(torch.float32)
    s, z = _broadcast_t(qp, x)
    q = torch.round(x / s) + z
    q = q.clamp_(qp.qmin, qp.qmax)
    return q.to(torch.int32 if qp.bits > 8 else torch.int8)


def dequantize_t(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    """:func:`dequantize` on a tensor, on its device.  numpy multiplies
    the int64 ``q - z`` by the float32 scale in float64 and rounds to
    float32 once; for ``|q - z| < 2^24`` (every stored int8) that is the
    correctly rounded float32 product computed here."""
    s, z = _broadcast_t(qp, q)
    return (q.to(torch.int32) - z).to(torch.float32) * s


def qparams_from_range(lo: float, hi: float, bits: int = 8,
                       symmetric: bool = False,
                       axis: Optional[int] = None) -> QParams:
    """Scale/zero-point from an observed float range (scalar form)."""
    return _qparams_from_ranges(np.asarray([lo]), np.asarray([hi]),
                                bits, symmetric, axis, scalar=True)


def qparams_per_channel(lo: np.ndarray, hi: np.ndarray, bits: int = 8,
                        symmetric: bool = True, axis: int = 0) -> QParams:
    """Per-channel qparams from per-channel ranges along ``axis``."""
    return _qparams_from_ranges(np.asarray(lo), np.asarray(hi),
                                bits, symmetric, axis, scalar=False)


def _qparams_from_ranges(lo: np.ndarray, hi: np.ndarray, bits: int,
                         symmetric: bool, axis: Optional[int],
                         scalar: bool) -> QParams:
    lo = np.minimum(np.asarray(lo, dtype=np.float64), 0.0)
    hi = np.maximum(np.asarray(hi, dtype=np.float64), 0.0)
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if symmetric:
        amax = np.maximum(np.abs(lo), np.abs(hi))
        scale = np.maximum(amax / qmax, _MIN_SCALE)
        zp = np.zeros_like(scale, dtype=np.int64)
    else:
        scale = np.maximum((hi - lo) / (qmax - qmin), _MIN_SCALE)
        zp = np.clip(np.round(qmin - lo / scale), qmin, qmax).astype(np.int64)
    if scalar:
        return QParams(np.float32(scale[0]), np.int64(zp[0]),
                       bits=bits, axis=None)
    return QParams(scale.astype(np.float32), zp, bits=bits, axis=axis)


# --------------------------------------------------------------------------
# int4 nibble packing
# --------------------------------------------------------------------------


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack signed int4 values (each in [-8, 7], stored one-per-int8)
    into a flat uint8 stream: two values per byte, low nibble first.
    Odd-length inputs get a zero pad nibble."""
    flat = np.asarray(q).reshape(-1).astype(np.int16)
    if flat.size and (flat.min() < -8 or flat.max() > 7):
        raise ValueError("values out of int4 range [-8, 7]")
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, dtype=np.int16)])
    u = (flat & 0xF).astype(np.uint8)          # two's-complement nibbles
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def unpack_int4(packed: np.ndarray, n: int,
                shape: Optional[Tuple[int, ...]] = None) -> np.ndarray:
    """Inverse of :func:`pack_int4`: first ``n`` signed int4 values,
    optionally reshaped."""
    p = np.asarray(packed, dtype=np.uint8).reshape(-1)
    lo = (p & 0xF).astype(np.int8)
    hi = (p >> 4).astype(np.int8)
    vals = np.empty(p.size * 2, dtype=np.int8)
    vals[0::2] = lo
    vals[1::2] = hi
    vals = np.where(vals >= 8, vals - 16, vals).astype(np.int8)[:n]
    return vals.reshape(shape) if shape is not None else vals
