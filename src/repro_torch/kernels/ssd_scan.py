"""Mamba2 SSD within a chunk on the H100 (state-space duality).

Launch wrapper of the hand-written CUDA kernel ``csrc/ssd_chunk.cu``,
which replaces the Pallas kernel of ``repro/kernels/ssd_scan.py``.  Per
(batch, chunk, head) it computes the decay-gated L x L quadratic form of
the chunk, the chunk's contribution to the state and its total decay; the
O(S/L) recurrence across chunks runs in PyTorch (``ref.ssd_scan_ref``).
Its plain PyTorch version is ``ref.ssd_chunk_ref``; ``ops.ssd_scan``
chooses between the two by the device of the inputs.  In bfloat16 the
kernel runs on the tensor cores, one block per (batch, chunk, group of
heads) computing C·Bᵀ once for the group; ``head_group`` picks the group.

``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import _build

launches = 0
_lock = threading.Lock()             # the counter, across threads

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
MAX_DIM = 128               # chunk, N and P are at most this
SMS = 132                   # streaming multiprocessors of an H100 SXM
MAX_GROUP = 8               # heads a block of the bf16 body takes at most
MIN_WAVES = 1.5             # head_group keeps at least this many waves


def head_group(pairs: int, H: int) -> int:
    """Heads per block of the bf16 body for ``pairs`` (batch, chunk)
    pairs of H heads: the largest group, up to MAX_GROUP, whose grid of
    ``pairs * ceil(H / group)`` blocks still makes MIN_WAVES waves of the
    SMS SMs; 1 where even one head a block does not.  A block computes
    C·Bᵀ once for its group but runs the group's heads one after another,
    so a larger group trades C·Bᵀ products for fewer blocks in flight."""
    for group in range(min(MAX_GROUP, H), 1, -1):
        if pairs * -(-H // group) >= MIN_WAVES * SMS:
            return group
    return 1


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H) f32; A (H,) f32; Bm/Cm (B,S,N); S a multiple
    of `chunk`.

    Returns (y_intra (B,S,H,P), contrib (B,nc,H,P,N), total (B,nc,H),
    seg (B,S,H)), all f32, as ``ref.ssd_chunk_ref``.  The bf16 body takes
    ``head_group`` heads a block.  Launches on the current stream and
    never synchronises.  Raises on inputs the kernel does not take:
    tensors off CUDA, x/Bm/Cm other than one float32 or bfloat16 dtype, dt
    or A not float32, chunk, N or P above 128."""
    global launches
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"x must be (B,S,H,P) and Bm (B,S,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,)
            or Bm.shape != (Bsz, S, N) or Cm.shape != (Bsz, S, N)):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)} do not match")
    if min(Bsz, S, H, P, N, chunk) < 1 or max(P, N, chunk) > MAX_DIM:
        raise ValueError(f"ssd_chunk takes nonempty B, S, H and 1 <= chunk, "
                         f"N, P <= {MAX_DIM}; got x {tuple(x.shape)}, "
                         f"N={N}, chunk={chunk}")
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd_chunk's kernel takes CUDA tensors on one "
                         "device")
    if x.dtype not in _build.DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_chunk takes float32 or bfloat16 x, Bm, Cm of "
                        f"one dtype; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_chunk takes float32 dt and A; got {dt.dtype}, "
                        f"{A.dtype}")
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    nc = S // chunk
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((Bsz, S, H, P), **f32)
    contrib = torch.empty((Bsz, nc, H, P, N), **f32)
    total = torch.empty((Bsz, nc, H), **f32)
    seg = torch.empty((Bsz, S, H), **f32)
    fn = _build.function("ssd_chunk", "ssd_chunk_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), contrib.data_ptr(),
                total.data_ptr(), seg.data_ptr(), Bsz, S, H, P, N, chunk,
                head_group(Bsz * nc, H), _build.DTYPE_CODES[x.dtype],
                _build.stream_of(x))
    _build.check(rc, "ssd_chunk")
    with _lock:
        launches += 1
    return y, contrib, total, seg
