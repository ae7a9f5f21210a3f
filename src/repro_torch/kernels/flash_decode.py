"""Flash-decode on the H100: one new token against a long KV cache.

Launch wrapper of the hand-written CUDA kernel ``csrc/flash_decode.cu``,
which replaces the Pallas kernel of ``repro/kernels/flash_decode.py``.
Decode attention is memory-bound work; the kernel streams each lane's
valid prefix of the cache once, with 16-byte loads, computing all the
query heads of a kv head in one block with an f32 streaming softmax.
Where ``B * Hkv`` blocks would leave SMs idle, the cache is split into
key ranges (``num_splits``) that are combined by LSE in the same launch.
Its plain PyTorch version is ``ref.flash_decode_ref``;
``ops.flash_decode`` chooses between the two by the device of the
inputs.

``launches`` counts the kernel launches of this process,
``launches_by_shape`` the same launches by ``shape_key``, and
``lse_launches`` those that also wrote the log-sum-exp (a
sequence-sharded decode's, ``models.attention._decode_seq_sharded``).
"""
from __future__ import annotations

import ctypes
import math
import threading
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from . import _build

launches = 0
lse_launches = 0
launches_by_shape: Counter = Counter()
# guards the counters and the scratch dict: serving workers launch from
# several threads
_lock = threading.Lock()

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
MAX_HEAD_DIM = 256
SMS = 132                 # streaming multiprocessors of an H100 SXM
MIN_SPLIT_KEYS = 64       # no key range of a split is shorter

# Per (device index, stream handle): the f32 partials of the splits and
# the int32 tickets, which the kernel leaves at 0.
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def shape_key(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple:
    """(B, H, D, Hkv, S, Dv): what ``launches_by_shape`` counts a launch
    under."""
    return (*q.shape, k.shape[1], k.shape[2], v.shape[-1])


def num_splits(B: int, Hkv: int, S: int) -> int:
    """How many key ranges each (b, kv head) of a cache of S keys is split
    into: enough that ``B * Hkv * splits`` blocks fill the SMS SMs, as far
    as every range keeps at least MIN_SPLIT_KEYS keys; at least 1."""
    want = -(-SMS // max(1, B * Hkv))
    return max(1, min(want, S // MIN_SPLIT_KEYS))


def split_bounds(S: int, splits: int) -> List[Tuple[int, int]]:
    """The key range [lo, hi) of each split, as the kernel computes it:
    balanced, so that the lengths differ by at most one."""
    return [(i * S // splits, (i + 1) * S // splits) for i in range(splits)]


def _scratch_for(dev: torch.device, stream: int, n_part: int,
                 n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split scratch of (device, stream), grown to hold the sizes
    asked for.  Tickets are zeroed when they are allocated; the kernel
    resets each to 0, so no call needs a memset."""
    key = (dev.index, stream)
    with _lock:
        part, tickets = _scratch.get(key, (None, None))
        if part is None or part.numel() < n_part:
            part = torch.empty(n_part, dtype=torch.float32, device=dev)
        if tickets is None or tickets.numel() < n_tickets:
            tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
        _scratch[key] = (part, tickets)
    return part, tickets


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: Optional[torch.Tensor] = None,
                 sm_scale: Optional[float] = None,
                 block_k: int = 256, return_lse: bool = False):
    """q (B,H,D); k (B,Hkv,S,D); v (B,Hkv,S,Dv); kv_len (B,) int.

    Returns o (B,H,Dv) in q's dtype and, with ``return_lse``, the (B,H)
    f32 log-sum-exp.  Query head h reads kv head h // (H // Hkv).
    ``block_k`` is accepted for the JAX API and ignored: the kernel's
    tiles are fixed, and the key ranges come from ``num_splits``.  The
    split scratch is allocated once and kept per (device, stream).
    Launches once on the current stream and never synchronises.  Raises
    on inputs the kernel does not take: tensors off CUDA, dtypes other
    than float32/bfloat16, D or Dv above 256."""
    global launches, lse_launches
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
    q = q.contiguous()
    k, v = _build.aligned(k), _build.aligned(v)
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
    stream = _build.stream_of(q)
    splits = num_splits(B, Hkv, S)
    part = tickets = None
    if splits > 1:
        part, tickets = _scratch_for(dev, stream, B * H * splits * (Dv + 2),
                                     B * H)
    fn = _build.function("flash_decode", "flash_decode_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), lse.data_ptr() if lse is not None else None,
                part.data_ptr() if part is not None else None,
                tickets.data_ptr() if tickets is not None else None,
                B, H, Hkv, S, D, Dv, splits, sm_scale,
                _build.DTYPE_CODES[q.dtype], stream)
    _build.check(rc, "flash_decode")
    with _lock:
        launches += 1
        lse_launches += return_lse
        launches_by_shape[shape_key(q, k, v)] += 1
    return (out, lse) if return_lse else out
