"""Plain PyTorch versions of the kernels of the port.

Counterpart of ``repro/kernels/ref.py``.  These are the semantics of the
hand-written CUDA kernels: the CPU path of ``ops.py``, and the value
that the tests and ``chip_smoke.py`` hold each kernel against on the
card.  They run on whatever device their inputs lie on.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Fused-epilogue activations (the Neutron activation engine, paper §III-B)
# --------------------------------------------------------------------------


def apply_activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act in ("none", None):
        return x
    if act == "relu":
        return F.relu(x)
    if act == "relu6":
        return torch.clamp(x, 0, 6)
    if act == "silu":
        return F.silu(x)
    if act == "gelu":                          # jax.nn.gelu's tanh form
        return F.gelu(x, approximate="tanh")
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "sqrelu":                        # nemotron-4 squared ReLU
        r = F.relu(x)
        return r * r
    if act == "mish":
        return x * torch.tanh(F.softplus(x))
    raise ValueError(f"unknown activation {act!r}")


ACTIVATIONS = ("none", "relu", "relu6", "silu", "gelu", "sigmoid",
               "sqrelu", "mish")

#: the activations of the IR (``core/ir.py`` ACTIVATIONS), in the order of
#: the codes K1 takes (``csrc/neutron_matmul.cu`` enum Act).
IR_ACTIVATIONS = ("none", "relu", "relu6", "hswish", "hsigmoid", "silu",
                  "sigmoid", "gelu", "mish", "sqrelu", "leaky")


def ir_activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """``core/ir.py:_apply_act`` on a float32 tensor, operation for
    operation, on its device.  Divisions are by 0-d device tensors (on
    CUDA a division by a Python number is a multiply by its reciprocal).
    gelu returns float64, as numpy's does (its sqrt(2/pi) is a float64
    scalar); the callers quantize, which rounds to float32 first."""
    if act in ("none", None):
        return x
    if act == "relu":
        return torch.clamp_min(x, 0)
    if act == "relu6":
        return torch.clamp(x, 0, 6)
    six = torch.tensor(6.0, dtype=torch.float32, device=x.device)
    if act == "hswish":
        return x * torch.clamp(x + 3, 0, 6) / six
    if act == "hsigmoid":
        return torch.clamp(x + 3, 0, 6) / six
    if act == "silu":
        return x / (1 + torch.exp(-torch.clamp(x, -30, 30)))
    if act == "sigmoid":
        return 1 / (1 + torch.exp(-torch.clamp(x, -30, 30)))
    if act == "gelu":
        inner = (x + 0.044715 * x ** 3).double()
        return (0.5 * x).double() * (1 + torch.tanh(
            math.sqrt(2 / math.pi) * inner))
    if act == "mish":
        sp = torch.log1p(torch.exp(-x.abs())) + torch.clamp_min(x, 0)
        return x * torch.tanh(sp)
    if act == "sqrelu":
        r = torch.clamp_min(x, 0)
        return r * r
    if act == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    raise ValueError(act)


# --------------------------------------------------------------------------
# neutron_matmul (K1): output-stationary matmul + fused epilogue
# --------------------------------------------------------------------------


def int_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer operands x (..., K) @ w (K, N): the
    float64 product is exact while K * 128 * 128 < 2^53, and runs on any
    device (cuBLAS has no int32 GEMM)."""
    return (x.double() @ w.double()).to(torch.int32)


def neutron_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, scale=None,
                       act: str = "none",
                       out_dtype: Optional[torch.dtype] = None,
                       out_scale: Optional[float] = None) -> torch.Tensor:
    """The Pallas contract: y = requant(act(scale * (x @ w) + bias)).

    int8 inputs accumulate exactly (int32 semantics); float inputs in
    float32.  ``scale`` is a number or (N,); ``out_scale`` requantizes
    to int8 with ``clip(round(acc / out_scale), -128, 127)``."""
    if x.dtype == torch.int8:
        acc = int_dot(x, w).to(torch.float32)
    else:
        acc = x.float() @ w.float()
    if scale is not None:
        acc = acc * torch.as_tensor(scale, dtype=torch.float32).to(x.device)
    if bias is not None:
        acc = acc + bias.to(x.device, torch.float32)
    acc = apply_activation(acc, act)
    if out_scale is not None:
        q = torch.round(acc / torch.tensor(float(out_scale),
                                           dtype=torch.float32,
                                           device=x.device))
        return q.clamp_(-128, 127).to(torch.int8)
    return acc.to(out_dtype or (x.dtype if x.dtype != torch.int8
                                else torch.float32))


def neutron_matmul_nk_ref(x: torch.Tensor, wt: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          act: str) -> torch.Tensor:
    """The Pallas contract in float32 with an (N, K) weight, on x
    float32 (batch, M, K) or (batch, R, C, K): ``act(x @ wt^T + bias)``
    as float32 (batch, M, N), ``act`` one of the IR's activations
    (``ir_activation``)."""
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    y = x @ wt.t()
    if bias is not None:
        y = y + bias
    return ir_activation(y, act).to(torch.float32)


def neutron_matmul_plan_ref(x: torch.Tensor, w: torch.Tensor,
                            bias: Optional[torch.Tensor], sc: torch.Tensor,
                            act: str, out_scale: float, out_zp: int,
                            qmin: int, qmax: int) -> torch.Tensor:
    """The plan contract on x int8 (batch, M, K) or (batch, R, C, K),
    w int8 (N, K): ``clip(round(act(f32(x @ w^T + bias) * sc) / out_scale)
    + out_zp, qmin, qmax)`` as int8 (batch, M, N).  The expression of
    ``quant/execplan.py`` (accumulate, add the zero-point-folded bias,
    rescale) followed by ``quantize``."""
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    acc = int_dot(x, w.t())
    if bias is not None:
        acc = acc + bias
    y = ir_activation(acc.to(torch.float32) * sc, act).to(torch.float32)
    q = torch.round(y / torch.tensor(float(out_scale), dtype=torch.float32,
                                     device=y.device)) + int(out_zp)
    return q.clamp_(qmin, qmax).to(torch.int8)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        block_k: int = 512,
                        q_offset: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Streaming-softmax attention, O(S·block_k) memory.

    q (B,H,S,D); k (B,H,Sk,D); v (B,H,Sk,Dv): the heads of q and k/v are
    equal here (``ops.flash_attention`` repeats grouped kv heads first).
    ``q_offset`` (B,) int places query row i of lane b at key position
    ``q_offset[b] + i``: key j is then valid iff ``j < q_offset[b] + S``
    and, when causal, ``j <= q_offset[b] + i`` (the window counts from
    the same position).  None is an offset of 0 with no ``j < S`` bound,
    the Pallas kernel's mask.
    """
    return _flash_forward(q, k, v, causal, window, sm_scale, block_k,
                          q_offset)[0]


def flash_attention_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                window: Optional[int] = None,
                                sm_scale: Optional[float] = None,
                                block_k: int = 512
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_ref`` that also returns the float32 log-sum-exp
    (B, H, S) of each row's scores, ``m + log(max(l, 1e-30))``: the
    counterpart of ``_flash_fwd_lse`` (``repro/kernels/ref.py:167``), the
    forward of the fused-backward attention.  H == Hkv."""
    return _flash_forward(q, k, v, causal, window, sm_scale, block_k, None)


def _flash_forward(q, k, v, causal, window, sm_scale, block_k, q_offset):
    """(o in q's dtype, lse float32) of the streaming softmax."""
    B, H, S, D = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[2]
    sm_scale = sm_scale or 1.0 / math.sqrt(D)
    block_k = min(block_k, Sk)
    nk = math.ceil(Sk / block_k)
    qf = q.float()
    qi = torch.arange(S, device=q.device)[:, None]
    kv_lim = Sk
    if q_offset is not None:
        off = q_offset.to(q.device, torch.int64).reshape(B, 1, 1, 1)
        qi = qi + off                                   # (B,1,S,1)
        kv_lim = off + S
    m = torch.full((B, H, S), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, Dv), dtype=torch.float32, device=q.device)
    for j in range(nk):
        kc = k[:, :, j * block_k:(j + 1) * block_k].float()
        vc = v[:, :, j * block_k:(j + 1) * block_k].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * sm_scale
        kj = j * block_k + torch.arange(kc.shape[2], device=q.device)[None]
        mask = (kj < Sk) & (kj < kv_lim)
        if causal:
            mask = mask & (kj <= qi)
        if window is not None:
            mask = mask & (qi - kj < window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True,
                            window: Optional[int] = None,
                            sm_scale: Optional[float] = None,
                            block_k: int = 512
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward of the fused attention from its residuals, the
    counterpart of ``_faf_bwd`` (``repro/kernels/ref.py:236``): each key
    block's scores are recomputed, ``P = exp(s - lse)`` under the
    forward's mask, ``delta = rowsum(do * o)`` in float32, and
    ``dV = P^T dO``, ``dS = P (dO V^T - delta) sm_scale``, ``dQ = dS K``,
    ``dK = dS^T Q``.  q (B,H,S,D), k (B,H,Sk,D), v (B,H,Sk,Dv) with
    H == Hkv, o and do (B,H,S,Dv), lse (B,H,S) float32.  Returns (dq, dk,
    dv) in the dtypes of q, k and v."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    sm = sm_scale or 1.0 / math.sqrt(D)
    bk = min(block_k, Sk)
    qf, dof = q.float(), do.float()
    delta = (dof * o.float()).sum(dim=-1)                   # (B,H,S)
    qi = torch.arange(S, device=q.device)[:, None]
    dq = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j0 in range(0, Sk, bk):
        kc = k[:, :, j0:j0 + bk].float()
        vc = v[:, :, j0:j0 + bk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * sm
        kj = j0 + torch.arange(kc.shape[2], device=q.device)[None]
        mask = (kj <= qi) if causal else torch.ones(
            (S, kc.shape[2]), dtype=torch.bool, device=q.device)
        if window is not None:
            mask = mask & (qi - kj < window)
        p = torch.where(mask, torch.exp(s - lse[..., None]),
                        torch.zeros_like(s))
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, dof))
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vc)
        ds = p * (dp - delta[..., None]) * sm
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kc)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf))
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None,
                     return_lse: bool = False):
    """Single-token decode attention.  q (B,H,D); k (B,H,S,D);
    v (B,H,S,Dv).

    `kv_len` (B,) masks the valid prefix of the cache.  With
    ``return_lse`` the (B,H) log-sum-exp is returned as well.  With
    ``kv_len == 0`` this gives the mean of v where the kernel gives 0.
    """
    B, H, S, D = k.shape
    sm_scale = sm_scale or 1.0 / math.sqrt(D)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) * sm_scale
    if kv_len is not None:
        mask = (torch.arange(S, device=k.device)[None, None, :]
                < kv_len.to(k.device)[:, None, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhk,bhkd->bhd", p, v.float())
    o = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    if return_lse:
        lse = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))
        return o, lse
    return o


def combine_decode_shards(outs: torch.Tensor, lses: torch.Tensor
                          ) -> torch.Tensor:
    """Merge per-shard decode partials by the log-sum-exp identity: outs
    (N, B, H, D) and their lses (N, B, H), one per key range, into
    (B, H, D) in outs' dtype.  A shard that saw no key (lse -1e30)
    weighs nothing."""
    m = lses.max(dim=0).values
    w = torch.exp(lses - m)                          # (N, B, H)
    denom = w.sum(dim=0)
    o = (outs.float() * w[..., None]).sum(dim=0)
    return (o / torch.clamp(denom, min=1e-30)[..., None]).to(outs.dtype)


# --------------------------------------------------------------------------
# Mamba2 SSD (state-space duality) chunked scan
# --------------------------------------------------------------------------


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Intra-chunk SSD, the four outputs of ``repro/kernels/ssd_scan.py``'s
    ``ssd_chunk``.  x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N); S a
    multiple of `chunk`.

    Returns, all f32: y_intra (B,S,H,P), the chunk state contributions
    contrib (B,nc,H,P,N), the chunk decays total (B,nc,H) and the
    inclusive cumsum of dt*A within each chunk, seg (B,S,H)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc, L = S // chunk, chunk
    xc = x.reshape(Bsz, nc, L, H, P).float()
    dtc = dt.reshape(Bsz, nc, L, H).float()
    Bc = Bm.reshape(Bsz, nc, L, N).float()
    Cc = Cm.reshape(Bsz, nc, L, N).float()
    seg = torch.cumsum(dtc * A.float(), dim=2)              # (B,nc,L,H)
    # y[t] = sum_{s<=t} C[t].B[s] exp(seg[t]-seg[s]) dt[s] x[s]; above the
    # diagonal the exponent is positive and may overflow, so it is masked
    # to -inf before the exp
    cb = torch.einsum("bcln,bcmn->bclm", Cc, Bc)            # (B,nc,L,L)
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]   # (B,nc,L,L,H)
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    gate = torch.exp(decay.masked_fill(~tri[:, :, None], -math.inf))
    scores = cb[..., None] * gate * dtc[:, :, None]
    y = torch.einsum("bclmh,bcmhp->bclhp", scores, xc)
    # contribution of the chunk to the state after it:
    # sum_s exp(seg[L-1]-seg[s]) dt[s] x[s] (x) B[s]
    w = torch.exp(seg[:, :, -1:, :] - seg) * dtc            # (B,nc,L,H)
    contrib = torch.einsum("bclhp,bcln->bchpn", xc * w[..., None], Bc)
    total = torch.exp(seg[:, :, -1, :])                     # (B,nc,H)
    return (y.reshape(Bsz, S, H, P), contrib, total,
            seg.reshape(Bsz, S, H))


def ssd_chunk_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, seg: torch.Tensor,
                      dy: torch.Tensor, dcontrib: torch.Tensor,
                      dtotal: torch.Tensor, dseg: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
    """The backward of ``ssd_chunk_ref`` in explicit formulas: from its
    inputs, its output seg and the cotangents of its four outputs (dy
    (B,S,H,P), dcontrib (B,nc,H,P,N), dtotal (B,nc,H), dseg (B,S,H)),
    the gradients (dx, ddt, dA, dBm, dCm), all float32.  The JAX package
    has no such function: it differentiates ``ssd_scan_ref`` by autodiff.

    Per (b, chunk, head), with E[t,s] = exp(seg[t]-seg[s]) for s <= t
    (else 0), G[t,s] = (C[t].B[s]) E[t,s] dt[s], W[s] = exp(seg[L-1] -
    seg[s]) dt[s]:
      dG = dy x^T (s <= t); dx = G^T dy + W[s] Q[s], Q = B dcontrib^T;
      dC = (dG E dt) B, dB = (dG E dt)^T C + W[s] x[s] dcontrib, summed
      over the heads; the exponents give seg the row sums of R = dG G
      less its column sums, W gives it -dW W (and their sum to seg[L-1],
      with dtotal total), dW = sum_p x Q; seg = cumsum(dt A) hands that
      total back as a reverse cumulative sum rc: ddt += A rc and
      dA = sum dt rc over batch, chunks and rows."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc, L = S // chunk, chunk
    xc = x.reshape(Bsz, nc, L, H, P).float()
    dtc = dt.reshape(Bsz, nc, L, H).float()
    Bc = Bm.reshape(Bsz, nc, L, N).float()
    Cc = Cm.reshape(Bsz, nc, L, N).float()
    sg = seg.reshape(Bsz, nc, L, H).float()
    dyc = dy.reshape(Bsz, nc, L, H, P).float()
    dsg = dseg.reshape(Bsz, nc, L, H).float()
    dcf = dcontrib.float()
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    # E (B,nc,L_t,L_s,H), masked to -inf above the diagonal before the exp
    E = torch.exp((sg[:, :, :, None] - sg[:, :, None]).masked_fill(
        ~tri[:, :, None], -math.inf))
    cbe = torch.einsum("bcln,bcmn->bclm", Cc, Bc)[..., None] * E
    G = cbe * dtc[:, :, None]
    dG = torch.einsum("bclhp,bcmhp->bclmh", dyc, xc) * tri[:, :, None]
    ew = torch.exp(sg[:, :, -1:] - sg)                      # (B,nc,L,H)
    W = ew * dtc
    Q = torch.einsum("bcsn,bchpn->bcshp", Bc, dcf)          # (B,nc,L,H,P)
    dx = torch.einsum("bclmh,bclhp->bcmhp", G, dyc) + W[..., None] * Q
    dW = (xc * Q).sum(-1)                                   # (B,nc,L,H)
    dcb = (dG * E * dtc[:, :, None]).sum(-1)                # (B,nc,L,L)
    dCm = torch.einsum("bclm,bcmn->bcln", dcb, Bc)
    dBm = torch.einsum("bclm,bcln->bcmn", dcb, Cc) + torch.einsum(
        "bcshp,bchpn->bcsn", xc * W[..., None], dcf)
    R = dG * G
    gs = dsg + R.sum(3) - R.sum(2) - dW * W
    last = (dW * W).sum(2) + dtotal.float() * torch.exp(sg[:, :, -1])
    gs = torch.cat([gs[:, :, :-1], gs[:, :, -1:] + last[:, :, None]], dim=2)
    rc = torch.flip(torch.cumsum(torch.flip(gs, (2,)), dim=2), (2,))
    ddt = (dG * cbe).sum(2) + dW * ew + rc * A.float()
    dA = (rc * dtc).sum((0, 1, 2))
    return (dx.reshape(Bsz, S, H, P), ddt.reshape(Bsz, S, H), dA,
            dBm.reshape(Bsz, S, N), dCm.reshape(Bsz, S, N))


ChunkFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]]


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64,
                 init_state: Optional[torch.Tensor] = None,
                 chunk_fn: ChunkFn = ssd_chunk_ref
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD forward (Mamba2, arXiv:2405.21060 §6).

    x (B,S,H,P); dt (B,S,H) softplus-activated step sizes (> 0); A (H,)
    negative decay rates; Bm/Cm (B,S,N) (single group); init_state
    (B,H,P,N) or None.  Returns (y (B,S,H,P), final state (B,H,P,N)), both
    in x's dtype.

    S is padded with zeros to a multiple of `chunk` (dt = 0 there, so the
    padded rows change no state); `chunk_fn` computes the intra-chunk part
    (``ssd_chunk_ref`` or the CUDA kernel, ``ops.ssd_scan``); the O(S/L)
    recurrence across chunks and its contribution to y run here."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = math.ceil(S / chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y_in, contrib, total, seg = chunk_fn(x, dt, A, Bm, Cm, chunk)
    s = (init_state.float() if init_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                          device=x.device))
    s_prevs = []
    for c in range(nc):                 # the state entering each chunk
        s_prevs.append(s)
        s = s * total[:, c, :, None, None] + contrib[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                   # (B,nc,H,P,N)
    L = chunk
    Cc = Cm.reshape(Bsz, nc, L, N).float()
    decay_in = torch.exp(seg.reshape(Bsz, nc, L, H))
    # y[t] += exp(seg[t]) C[t] . S_prev
    y_out = torch.einsum("bcln,bchpn->bclhp", Cc, s_prevs) \
        * decay_in[..., None]
    y = (y_in.reshape(Bsz, nc, L, H, P) + y_out).reshape(
        Bsz, nc * L, H, P)[:, :S]
    return y.to(x.dtype), s.to(x.dtype)


def ssd_step_ref(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                 A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence (decode).  state (B,H,P,N); x (B,H,P);
    dt (B,H); Bm/Cm (B,N).  Returns y (B,H,P) in x's dtype and the new
    state in the state's dtype (a bf16 state is rounded every step, as in
    the JAX package)."""
    dtf = dt.float()
    da = torch.exp(dtf * A.float()[None, :])                # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dtf, Bm.float(), x.float())
    new = state.float() * da[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), new)
    return y.to(x.dtype), new.to(state.dtype)
