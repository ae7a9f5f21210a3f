"""The kernels on the meta device: what ``ops`` calls in place of a CUDA
wrapper when its inputs are meta tensors (the dry run,
``launch/dryrun.py``).

Each function takes its wrapper's arguments and returns meta tensors of
the shapes and dtypes the kernel writes (K2's and K3's log-sum-exp
included), computing nothing, and reports the call, its operations and
its bytes (``kernels/work.py``) to the active cost counter
(``analysis.cost``).  The plain version never runs on meta: it would
count work the kernel does not do, such as K2's S x Sk score matrix.
The wrappers' launch counters are not touched: nothing is launched.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis import cost
from . import work


def _report(name: str, flops, *tensors) -> None:
    c = cost.active()
    if c is not None:
        c.kernel(name, flops, work.nbytes(*tensors))


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    sm_scale: Optional[float] = None, q_offset=None,
                    return_lse: bool = False, **block_kw):
    """K2: o (B,H,S,Dv) in q's dtype [, lse (B,H,S) float32].  With a
    query offset every (query, key) pair counts (``work``)."""
    B, H, S, D = q.shape
    Sk, Dv = k.shape[2], v.shape[-1]
    out = torch.empty((B, H, S, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q_offset is not None:
        causal, window = False, None
    _report("flash_attention",
            {work.rate_of(q.dtype): work.flash_attention_flops(
                B, H, S, Sk, D, Dv, causal, window)},
            q, k, v, q_offset, out, lse)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None):
    """K2b: (dq, dk, dv) in the shapes and dtypes of q, k and v."""
    B, H, S, D = q.shape
    Sk, Dv = k.shape[2], v.shape[-1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _report("flash_attention_bwd",
            {work.rate_of(q.dtype): work.flash_attention_bwd_flops(
                B, H, S, Sk, D, Dv, causal, window)},
            q, k, v, o, lse, do, dq, dk, dv)
    return dq, dk, dv


def flash_decode(q, k, v, kv_len=None, sm_scale: Optional[float] = None,
                 block_k: int = 256, return_lse: bool = False):
    """K3: o (B,H,Dv) in q's dtype [, lse (B,H) float32]; every cached
    position counts (``work``)."""
    B, H, D = q.shape
    S, Dv = k.shape[2], v.shape[-1]
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _report("flash_decode",
            {work.rate_of(q.dtype): work.flash_decode_flops(B, H, S, D, Dv)},
            q, k, v, kv_len, out, lse)
    return (out, lse) if return_lse else out


def ssd_chunk(x, dt, A, Bm, Cm, chunk: int):
    """K4: (y_intra (B,S,H,P), contrib (B,nc,H,P,N), total (B,nc,H),
    seg (B,S,H)), all float32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    kw = dict(dtype=torch.float32, device=x.device)
    outs = (torch.empty((Bsz, S, H, P), **kw),
            torch.empty((Bsz, nc, H, P, N), **kw),
            torch.empty((Bsz, nc, H), **kw), torch.empty((Bsz, S, H), **kw))
    _report("ssd_chunk",
            {work.rate_of(x.dtype): work.ssd_flops(Bsz, S, H, P, N, chunk)},
            x, dt, A, Bm, Cm, *outs)
    return outs


def ssd_chunk_bwd(x, dt, A, Bm, Cm, seg, dy, dcontrib, dtotal, dseg,
                  chunk: int):
    """K4b: (dx, ddt, dA, dBm, dCm), float32, in the shapes of the
    inputs.  The bf16 body's operations by rate (``work``); the float32
    body's all at the float32 rate."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    grads = tuple(torch.empty(t.shape, dtype=torch.float32, device=x.device)
                  for t in (x, dt, A, Bm, Cm))
    flops = work.ssd_bwd_flops(Bsz, S, H, P, N, chunk)
    if x.dtype == torch.float32:
        flops = {"float32": sum(flops.values())}
    _report("ssd_chunk_bwd", flops, x, dt, A, Bm, Cm, seg, dy, dcontrib,
            dtotal, dseg, *grads)
    return grads


def neutron_matmul(x, w, bias=None, scale=None, act: str = "none",
                   out_dtype=None, out_scale: Optional[float] = None,
                   **block_kw):
    """K1's Pallas contract: y (M,N)."""
    M, K = x.shape
    N = w.shape[1]
    if out_dtype is None:
        out_dtype = torch.int8 if out_scale is not None else (
            torch.float32 if x.dtype == torch.int8 else x.dtype)
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    _report("neutron_matmul", work.matmul_flops(M, N, K, x.dtype), x, w,
            bias, y)
    return y


def neutron_matmul_plan(x, w, bias, sc, act: str, out_scale: float,
                        out_zp: int, qmin: int, qmax: int, out):
    """K1's int8 plan contract, into `out` (batch, M, N)."""
    N, K = w.shape
    _report("neutron_matmul",
            work.matmul_flops(x.numel() // K, N, K, torch.int8), x, w, bias,
            sc, out)
    return out


def neutron_matmul_nk(x, wt, bias, act: str, out):
    """K1's float32 contract with an (N, K) weight, into `out`."""
    N, K = wt.shape
    _report("neutron_matmul",
            work.matmul_flops(x.numel() // K, N, K, x.dtype), x, wt, bias,
            out)
    return out
