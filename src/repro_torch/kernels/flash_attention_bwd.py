"""The backward of flash attention (K2b) on the H100: dq, dk and dv from
the forward's residuals.

Launch wrapper of the hand-written CUDA kernel
``csrc/flash_attention_bwd.cu``, the counterpart of ``_faf_bwd``
(``repro/kernels/ref.py:236``), the custom VJP the JAX package writes in
jnp around its fused attention.  From q, k, v, the forward's output o
and its float32 log-sum-exp (K2 with ``return_lse``) and the cotangent
do, it recomputes each (query tile, key tile) block's probabilities and
never stores an (S x S) matrix.  The row sums ``delta = rowsum(do o)``
first, then one block per key tile for dK and dV (summed over the query
heads of a kv head's group), then one block per query tile for dQ; no
atomics, so a step's gradients are the same bits on every run.  Two
routes, from :func:`bwd_plan` (a pure function): MMA, bf16 products on
the tensor cores, for bfloat16 with D and Dv multiples of 16 up to 192
(every trained path), where a small grid splits a large group over G
slices whose float32 partials a last kernel sums in slice order
(:func:`group_split`); SCALAR, the first version's f32 FMAs, for float32
and the other head dims.  Its plain PyTorch version is
``ref.flash_attention_bwd_ref``; ``ops.FlashAttentionFn`` chooses
between the two by the device of the inputs.

``launches`` counts the calls that launched the kernels (one per call,
three CUDA kernels each, five where a group is split),
``launches_by_shape`` the same by
``flash_attention.shape_key``.
"""
from __future__ import annotations

import ctypes
import math
import threading
from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .flash_attention import MAX_HEAD_DIM, shape_key

launches = 0
launches_by_shape: Counter = Counter()
_lock = threading.Lock()             # the counters, across threads

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2

SCALAR, MMA = 0, 1        # the routes
SMS = 132                 # streaming multiprocessors of an H100 SXM
MMA_TILE = 64             # keys of a dK/dV block of the MMA route
MMA_MAX_HEAD_DIM = 192    # the MMA route's largest D and Dv (multiples of 16)


class BwdPlan(NamedTuple):
    """How a call runs: ``route`` SCALAR or MMA, and ``G``, the slices
    its dK/dV grid splits each group of query heads into (1 on the
    SCALAR route, which walks a whole group in one block)."""
    route: int
    G: int


def group_split(B: int, Hkv: int, Sk: int, group: int) -> int:
    """Slices of a group of ``group`` query heads on the MMA route's dK/dV
    grid: 1 where B * Hkv * ceil(Sk / MMA_TILE) blocks fill the SMS SMs
    (or the group is 1), else the smallest divisor of the group that
    makes them fill it, else the whole group (one head a slice).  G
    always divides the group, so every slice has group / G heads."""
    blocks = B * Hkv * -(-Sk // MMA_TILE)
    if blocks >= SMS or group == 1:
        return 1
    for G in range(2, group + 1):
        if group % G == 0 and blocks * G >= SMS:
            return G
    return group


def bwd_plan(dtype: torch.dtype, B: int, Hkv: int, Sk: int, group: int,
             D: int, Dv: int) -> BwdPlan:
    """MMA for bfloat16 with D and Dv multiples of 16 up to
    MMA_MAX_HEAD_DIM, with ``group_split``'s G; else SCALAR with G 1."""
    if dtype == torch.bfloat16 and D % 16 == 0 and Dv % 16 == 0 and \
            max(D, Dv) <= MMA_MAX_HEAD_DIM:
        return BwdPlan(MMA, group_split(B, Hkv, Sk, group))
    return BwdPlan(SCALAR, 1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """q (B,H,S,D); k (B,Hkv,Sk,D); v (B,Hkv,Sk,Dv); o, do (B,H,S,Dv);
    lse (B,H,S) float32; H % Hkv == 0, query head h reading kv head
    h // (H // Hkv), the mask of K2 without a query offset.

    Returns (dq, dk, dv) in the shapes and dtype of q, k and v.  Takes
    what K2's forward takes but the offset: float32 or bfloat16 (one
    dtype for q, k, v, o, do), D and Dv multiples of 8 up to 256, a
    window >= 1 or None, S != Sk.  Tensors are made contiguous and
    16-byte aligned (copied only where they are not).  Launches on the
    current stream and never synchronises; raises on inputs the kernel
    does not take."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[-1]
    if k.shape != (B, Hkv, Sk, D) or v.shape != (B, Hkv, Sk, Dv) or \
            o.shape != (B, H, S, Dv) or do.shape != (B, H, S, Dv) or \
            lse.shape != (B, H, S):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, lse "
                         f"{tuple(lse.shape)}, do {tuple(do.shape)} do not "
                         f"match")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if min(B, H, S, Sk) < 1:
        raise ValueError(f"flash_attention_bwd takes nonempty B, H, S, Sk; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    if not (8 <= D <= MAX_HEAD_DIM and 8 <= Dv <= MAX_HEAD_DIM
            and D % 8 == 0 and Dv % 8 == 0):
        raise ValueError(f"flash_attention_bwd takes D, Dv in multiples of "
                         f"8 up to {MAX_HEAD_DIM}; got D={D}, Dv={Dv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, o, lse, do)):
        raise ValueError("flash_attention_bwd's kernel takes CUDA tensors "
                         "on one device")
    if q.dtype not in _build.DTYPE_CODES or \
            any(t.dtype != q.dtype for t in (k, v, o, do)) or \
            lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16 q, "
                        f"k, v, o, do of one dtype and a float32 lse; got "
                        f"{[t.dtype for t in (q, k, v, o, do, lse)]}")
    sm_scale = sm_scale or 1.0 / math.sqrt(D)
    q, k, v, o, lse, do = (_build.aligned(t) for t in (q, k, v, o, lse, do))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    route, G = bwd_plan(q.dtype, B, Hkv, Sk, H // Hkv, D, Dv)
    scratch = None if G == 1 else torch.empty(
        G * B * Hkv * Sk * (D + Dv), dtype=torch.float32, device=dev)
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                         _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Hkv, S,
                Sk, D, Dv, sm_scale, int(causal), int(window or 0),
                _build.DTYPE_CODES[q.dtype], route, G,
                None if scratch is None else scratch.data_ptr(),
                _build.stream_of(q))
    _build.check(rc, "flash_attention_bwd")
    with _lock:
        launches += 1
        launches_by_shape[shape_key(q, k, v, window)] += 1
    return dq, dk, dv
