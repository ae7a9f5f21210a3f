"""Flash-decode on the H100: one new token against a long KV cache.

Launch wrapper of the hand-written CUDA kernel ``csrc/flash_decode.cu``,
which replaces the Pallas kernel of ``repro/kernels/flash_decode.py``.
Decode attention is memory-bound work; the kernel streams each lane's
valid prefix of the cache once with an f32 streaming softmax.  Its plain
PyTorch version is ``ref.flash_decode_ref``; ``ops.flash_decode``
chooses between the two by the device of the inputs.

``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
MAX_HEAD_DIM = 256


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: Optional[torch.Tensor] = None,
                 sm_scale: Optional[float] = None,
                 block_k: int = 256, return_lse: bool = False):
    """q (B,H,D); k (B,Hkv,S,D); v (B,Hkv,S,Dv); kv_len (B,) int.

    Returns o (B,H,Dv) in q's dtype and, with ``return_lse``, the (B,H)
    f32 log-sum-exp.  Query head h reads kv head h // (H // Hkv).
    ``block_k`` is accepted for the JAX API and ignored: the kernel's
    tile is fixed.  Launches on the current stream and never
    synchronises.  Raises on inputs the kernel does not take: tensors
    off CUDA, dtypes other than float32/bfloat16, D or Dv above 256."""
    global launches
    B, H, D = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"k, v must be (B,Hkv,S,D); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _, Hkv, S, _ = k.shape
    Dv = v.shape[-1]
    if k.shape != (B, Hkv, S, D) or v.shape != (B, Hkv, S, Dv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if min(B, H, S, D, Dv) < 1 or max(D, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode takes 1 <= D, Dv <= {MAX_HEAD_DIM} "
                         f"and nonempty B, H, S; got {tuple(q.shape)}, "
                         f"{tuple(v.shape)}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_decode's kernel takes CUDA tensors on one "
                         "device")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_decode takes float32 or bfloat16 q, k, v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    sm_scale = sm_scale or 1.0 / math.sqrt(D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_len is None:
        kv_len = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        kv_len = kv_len.to(device=dev, dtype=torch.int32).contiguous()
        if kv_len.shape != (B,):
            raise ValueError(f"kv_len must be ({B},); got "
                             f"{tuple(kv_len.shape)}")
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    fn = _build.function("flash_decode", "flash_decode_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), lse.data_ptr() if lse is not None else None,
                B, H, Hkv, S, D, Dv, sm_scale, _build.DTYPE_CODES[q.dtype],
                _build.stream_of(q))
    _build.check(rc, "flash_decode")
    launches += 1
    return (out, lse) if return_lse else out
