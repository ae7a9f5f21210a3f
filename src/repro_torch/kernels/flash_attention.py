"""Flash attention (prefill) on the H100: causal / sliding-window / GQA.

Launch wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu``, which replaces the Pallas kernel of
``repro/kernels/flash_attention.py``.  Softmax statistics and the output
accumulator stay on chip while key tiles stream through shared memory;
no (S x S) score matrix reaches device memory.  bfloat16 inputs run on
the tensor cores (``mma.sync`` bf16, 128 query rows per block, K/V tiles
copied with double-buffered ``cp.async``; P is rounded to bf16 for the
P V product, as PyTorch's flash SDPA does); float32 inputs run a scalar
f32 body.  Its plain PyTorch version is ``ref.flash_attention_ref``;
``ops.flash_attention`` chooses between the two by the device of the
inputs.

``launches`` counts the kernel launches of this process, and
``launches_by_shape`` the same launches by ``shape_key``.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional, Tuple

import torch

from . import _build

launches = 0
launches_by_shape: Counter = Counter()

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
MAX_HEAD_DIM = 256


def shape_key(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> Tuple:
    """(B, H, S, D, Hkv, Sk, Dv, window): what ``launches_by_shape``
    counts a launch under."""
    return (*q.shape, k.shape[1], k.shape[2], v.shape[-1], window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q (B,H,S,D); k (B,Hkv,Sk,D); v (B,Hkv,Sk,Dv); H % Hkv == 0.

    Returns o (B,H,S,Dv) in q's dtype.  Query head h reads kv head
    h // (H // Hkv).  ``block_q``/``block_k`` are accepted for the JAX
    API and ignored: the kernel's tiles are fixed (128 query rows and 64
    keys in bf16, 32 keys above head dim 128; 16 rows and 64 keys in
    f32).  q, k and v are made contiguous and 16-byte aligned (copied
    only where they are not).  Launches on the current stream and never
    synchronises.  Raises on inputs the kernel does not take: tensors
    off CUDA, dtypes other than float32/bfloat16, D or Dv above 256 or
    not a multiple of 8, a window below 1."""
    global launches
    B, H, S, D = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"k, v must be (B,Hkv,Sk,D); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[-1]
    if k.shape != (B, Hkv, Sk, D) or v.shape != (B, Hkv, Sk, Dv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if min(B, H, S, Sk) < 1:
        raise ValueError(f"flash_attention takes nonempty B, H, S, Sk; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if not (8 <= D <= MAX_HEAD_DIM and 8 <= Dv <= MAX_HEAD_DIM
            and D % 8 == 0 and Dv % 8 == 0):
        raise ValueError(f"flash_attention takes D, Dv in multiples of 8 "
                         f"up to {MAX_HEAD_DIM}; got D={D}, Dv={Dv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention's kernel takes CUDA tensors on "
                         "one device")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, "
                        f"v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    sm_scale = sm_scale or 1.0 / math.sqrt(D)
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    out = torch.empty((B, H, S, Dv), dtype=q.dtype, device=dev)
    fn = _build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Hkv, S, Sk, D, Dv, sm_scale, int(causal),
                int(window or 0), _build.DTYPE_CODES[q.dtype],
                _build.stream_of(q))
    _build.check(rc, "flash_attention")
    launches += 1
    launches_by_shape[shape_key(q, k, v, window)] += 1
    return out
