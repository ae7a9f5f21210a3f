"""The backward of the Mamba2 SSD within a chunk (K4b) on the H100.

Launch wrapper of the hand-written CUDA kernel ``csrc/ssd_chunk_bwd.cu``:
the gradients of K4's four outputs (``ssd_scan.ssd_chunk``: y_intra,
contrib, total, seg) with respect to x, dt, A, Bm and Cm.  The JAX
package has no backward kernel to port: its models differentiate
``ssd_scan_ref`` (``repro/kernels/ref.py:331-391``) by autodiff, and this
computes the same gradient.  Its plain PyTorch version is
``ref.ssd_chunk_bwd_ref``; ``ops.SSDChunkFn`` chooses between the two by
the device of the inputs.

What bounds it on the card: the bytes it must move (dy, dcontrib and dx
in float32: 31 MB at mamba2-370m's training shape, 65 MB at
zamba2-2.7b's, 9-19 us at 3.35 TB/s); its products, at float32 accuracy
on the tensor cores, need 7-12 us at 495 TFLOP/s.  In bfloat16 (every
training path) a block of 16 warps takes a (batch, chunk) pair and a
group of ``bwd_head_group`` heads: C·Bᵀ once for the group on the bf16
tensor cores, every product with a float32 operand in 3xTF32
``mma.sync`` (two TF32 products where the other operand is bf16), only
the tiles on and above the diagonal (key s as the row), the row tiles
paired so that the warps share the triangle evenly, the next head's x
and dy staged while a head computes; the group's sums of dCB and of dB's
first term go to a scratch, a second launch sums them over the groups in
order and a third takes dC and dB's second term once per pair, so a
rerun gives the same bits (no atomics).  Float32 inputs, and bfloat16
shapes whose buffers do not fit a block, take the first design: scalar
FMAs, one block per (batch, chunk, head), per-head partials summed by a
second launch.  What is left: a block's first loads are not hidden
behind another block's work (one block an SM), the group partials cost
as many bytes as the compulsory traffic at one head a group, and the
``mma.sync`` chains issue well below the TF32 peak.

``launches`` counts the calls that launched the kernels (one per call;
three CUDA kernels each in bfloat16, two in float32).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from . import _build
from .ssd_scan import MAX_DIM, head_group

launches = 0
_lock = threading.Lock()             # the counter, across threads

_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SCRATCH_ARGTYPES = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]


def bwd_head_group(pairs: int, H: int) -> int:
    """Heads per block of the bf16 body for ``pairs`` (batch, chunk)
    pairs of H heads: K4's rule (``ssd_scan.head_group``), the largest
    group up to MAX_GROUP whose grid of ``pairs * ceil(H / group)``
    blocks still makes MIN_WAVES waves of the SMS SMs, else 1.  A block
    of this kernel fills an SM, so the waves are counted in blocks as
    for K4.  A larger group computes C·Bᵀ once for more heads and writes
    fewer dCB and dB partials, but puts fewer blocks in flight."""
    return head_group(pairs, H)


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, seg: torch.Tensor,
                  dy: torch.Tensor, dcontrib: torch.Tensor,
                  dtotal: torch.Tensor, dseg: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,N); seg (B,S,H), K4's
    own output; the cotangents dy (B,S,H,P), dcontrib (B,nc,H,P,N),
    dtotal (B,nc,H), dseg (B,S,H); S a multiple of `chunk`.

    Returns (dx (B,S,H,P), ddt (B,S,H), dA (H,), dBm (B,S,N), dCm
    (B,S,N)), all float32, as ``ref.ssd_chunk_bwd_ref``.  The bf16 body
    takes ``bwd_head_group`` heads a block.  Launches on the current
    stream and never synchronises.  Raises on inputs the kernel
    does not take: tensors off CUDA, x/Bm/Cm other than one float32 or
    bfloat16 dtype, any other input not float32, chunk, N or P above
    128."""
    global launches
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"x must be (B,S,H,P) and Bm (B,S,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if min(Bsz, S, H, P, N, chunk) < 1 or max(P, N, chunk) > MAX_DIM:
        raise ValueError(f"ssd_chunk_bwd takes nonempty B, S, H and 1 <= "
                         f"chunk, N, P <= {MAX_DIM}; got x "
                         f"{tuple(x.shape)}, N={N}, chunk={chunk}")
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    want = {"dt": (Bsz, S, H), "A": (H,), "Bm": (Bsz, S, N),
            "Cm": (Bsz, S, N), "seg": (Bsz, S, H), "dy": (Bsz, S, H, P),
            "dcontrib": (Bsz, nc, H, P, N), "dtotal": (Bsz, nc, H),
            "dseg": (Bsz, S, H)}
    given = dict(dt=dt, A=A, Bm=Bm, Cm=Cm, seg=seg, dy=dy, dcontrib=dcontrib,
                 dtotal=dtotal, dseg=dseg)
    bad = {k: tuple(t.shape) for k, t in given.items()
           if tuple(t.shape) != want[k]}
    if bad:
        raise ValueError(f"ssd_chunk_bwd: shapes {bad} do not fit x "
                         f"{tuple(x.shape)}, N={N}, chunk={chunk}")
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in given.values()):
        raise ValueError("ssd_chunk_bwd's kernel takes CUDA tensors on one "
                         "device")
    if x.dtype not in _build.DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_chunk_bwd takes float32 or bfloat16 x, Bm, Cm "
                        f"of one dtype; got {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}")
    f32 = [k for k in ("dt", "A", "seg", "dy", "dcontrib", "dtotal", "dseg")
           if given[k].dtype != torch.float32]
    if f32:
        raise TypeError(f"ssd_chunk_bwd takes float32 {f32}")
    x, dt, A, Bm, Cm, seg, dy, dcontrib, dtotal, dseg = (
        t.contiguous() for t in (x, dt, A, Bm, Cm, seg, dy, dcontrib,
                                 dtotal, dseg))
    kw = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((Bsz, S, H, P), **kw)
    ddt = torch.empty((Bsz, S, H), **kw)
    dA = torch.empty((H,), **kw)
    dB = torch.empty((Bsz, S, N), **kw)
    dC = torch.empty((Bsz, S, N), **kw)
    group = bwd_head_group(Bsz * nc, H)
    code = _build.DTYPE_CODES[x.dtype]
    floats = ctypes.c_longlong()
    size = _build.function("ssd_chunk_bwd", "ssd_chunk_bwd_scratch",
                           _SCRATCH_ARGTYPES)
    _build.check(size(Bsz, S, H, P, N, chunk, group, code,
                      ctypes.byref(floats)), "ssd_chunk_bwd")
    scratch = torch.empty(floats.value, **kw)
    fn = _build.function("ssd_chunk_bwd", "ssd_chunk_bwd_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), seg.data_ptr(), dy.data_ptr(),
                dcontrib.data_ptr(), dtotal.data_ptr(), dseg.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), scratch.data_ptr(), Bsz, S, H, P, N, chunk,
                group, code, _build.stream_of(x))
    _build.check(rc, "ssd_chunk_bwd")
    with _lock:
        launches += 1
    return dx, ddt, dA, dB, dC
