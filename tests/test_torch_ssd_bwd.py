"""The SSD scan's backward in the port: ``ref.ssd_chunk_bwd_ref`` (the
plain version of K4b) and ``ops.ssd_scan`` under grad (``SSDChunkFn``
and the cross-chunk recurrence through autograd) on the CPU.

The JAX package has no backward kernel for the scan: its models
differentiate ``repro.kernels.ref.ssd_scan_ref`` by autodiff, so the
port's gradients are held against ``jax.vjp`` of that function.  Inputs
and cotangents are drawn with numpy from a seed.  Tolerances: the
explicit formulas against autograd of ``ssd_chunk_ref`` at atol 2e-3 /
rtol 1e-3 (those of the K4 tests); against JAX, each gradient's
max|d| / max|JAX| below 2e-4 in float32 and 5e-2 with bf16 x, Bm, Cm
(both round the gradients of bf16 inputs to bf16).  The emulation of
K4b's bf16 body (its 3xTF32 products on bf16-valued inputs) is held to
1e-4 of each gradient's max, the limit the card holds the kernel to.
"""
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan_bwd as tssdb


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(rng, B, S, H, P, N, pad=0):
    """x, dt, A, Bm, Cm float32 as ssm_block gives them (dt > 0, A < 0),
    the last `pad` rows zero as ops.ssd_scan pads."""
    x = rng.normal(size=(B, S, H, P))
    dt = rng.uniform(1e-3, 0.1, (B, S, H))
    A = -rng.uniform(0.5, 2.0, (H,))
    Bm, Cm = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    for a in (x, dt, Bm, Cm):
        a[:, S - pad:] = 0
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("B,S,H,P,N,chunk,pad", [
    (2, 32, 3, 5, 4, 8, 0),         # nc 4
    (1, 64, 2, 16, 8, 32, 21),      # zero rows, as ops.ssd_scan pads
    (2, 48, 4, 8, 16, 16, 0),       # N > P
    (1, 16, 1, 3, 2, 16, 0),        # one chunk
])
def test_chunk_bwd_ref_matches_autograd(B, S, H, P, N, chunk, pad):
    """The explicit gradient of the intra-chunk SSD, all four cotangents
    folded in (dseg too: ssd_scan_ref reads seg again), against autograd
    through ssd_chunk_ref."""
    rng = np.random.default_rng(S + H)
    xs = [torch.from_numpy(a) for a in _inputs(rng, B, S, H, P, N, pad)]
    ins = [t.clone().requires_grad_(True) for t in xs]
    outs = tref.ssd_chunk_ref(*ins, chunk)
    cots = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
            for o in outs]
    want = torch.autograd.grad(outs, ins, cots)
    got = tref.ssd_chunk_bwd_ref(*xs, outs[3].detach(), *cots, chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-3, msg=name)
    if pad:                 # dt = 0 there: no gradient reaches those x
        assert not got[0][:, S - pad:].any()


@pytest.mark.parametrize("S,chunk,init,dtype", [
    (37, 16, True, "float32"),      # ragged: 11 padded rows, nc 3
    (64, 16, False, "float32"),     # nc 4, no padding
    (50, 8, True, "float32"),       # nc 7
    (37, 16, True, "bfloat16"),
    (64, 32, False, "bfloat16"),
])
def test_ssd_scan_grad_matches_jax_vjp(S, chunk, init, dtype):
    """ops.ssd_scan under grad against jax.vjp of the reference's
    ssd_scan_ref, with cotangents on y and on the final state: the
    gradients of x, dt, A, Bm, Cm and the initial state."""
    B, H, P, N = 2, 3, 8, 4
    rng = np.random.default_rng(S + chunk)
    xs = _inputs(rng, B, S, H, P, N)
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    ds = rng.normal(size=(B, H, P, N)).astype(np.float32)
    lowp = dtype == "bfloat16"
    if lowp:         # x, Bm, Cm (and so y, the state) in bf16; dt, A f32
        bf = ml_dtypes.bfloat16
        xs = [a.astype(bf) if i in (0, 3, 4) else a
              for i, a in enumerate(xs)]
        s0, dy, ds = (a.astype(bf) for a in (s0, dy, ds))

    jin = [jnp.asarray(a) for a in xs] + ([jnp.asarray(s0)] if init else [])

    def jfn(x, dt, A, Bm, Cm, *st):
        return jref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=st[0] if st else None)
    (jy, jfin), vjp = jax.vjp(jfn, *jin)
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))

    def tensor(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    tin = [tensor(a).requires_grad_(True)
           for a in xs + ([s0] if init else [])]
    y, fin = tops.ssd_scan(*tin[:5], chunk=chunk,
                           init_state=tin[5] if init else None)
    assert y.grad_fn is not None
    torch.autograd.backward((y, fin), (tensor(dy), tensor(ds)))
    limit = 5e-2 if lowp else 2e-4
    names = ("x", "dt", "A", "Bm", "Cm", "init_state")
    for name, t, w in zip(names, tin, want):
        w = np.asarray(w, np.float32)
        g = t.grad.float().numpy()
        assert g.shape == w.shape, name
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel < limit, (name, rel)
    for got, ref in ((y, jy), (fin, jfin)):
        ref = np.asarray(ref, np.float32)
        rel = np.abs(got.detach().float().numpy() - ref).max() / \
            np.abs(ref).max()
        assert rel < limit


# --------------------------------------------------------------------------
# K4b's bf16 body, its algebra emulated on the CPU
# --------------------------------------------------------------------------


def _tf32(v):
    """v with its low 13 mantissa bits cleared: what the tensor core reads
    of a float32 operand in TF32."""
    return (v.view(torch.int32) & -8192).view(torch.float32)


def _split(v, split=True):
    """The 3xTF32 halves of v: hi = tf32(v), lo = tf32(v - hi); with
    `split` False, plain TF32 (lo = 0)."""
    hi = _tf32(v)
    return hi, (_tf32(v - hi) if split else torch.zeros_like(v))


def _mm2(eq, a, b, split=True):
    """A product whose first operand is exact in TF32 (bf16 values) and
    whose second is float32: a.b_lo + a.b_hi, as two TF32 mma.sync."""
    hi, lo = _split(b, split)
    return torch.einsum(eq, a, lo) + torch.einsum(eq, a, hi)


def _mm3(eq, a, b, split=True):
    """A product of two float32 operands in 3xTF32: a_lo.b_hi + a_hi.b_lo
    + a_hi.b_hi."""
    ah, al = _split(a, split)
    bh, bl = _split(b, split)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _k4b_emulated(x, dt, A, Bm, Cm, seg, dy, dK, dtotal, dseg, chunk,
                  group, split=True):
    """The algebra of csrc/ssd_chunk_bwd.cu's bf16 body in PyTorch: every
    L x L product held as (key s, query t >= s); C.B^T once (exact bf16
    inputs); per head dG^T = x dy^T and Q = B dK^T, x dK with the float32
    operand split hi + lo (two TF32 products), G^T dy in 3xTF32; the
    group's sums of dCB^T and of dB's first term W x dK, then those sums
    over the groups, and dC, dB's second term from them (two TF32
    products: B, C exact).  Inputs x, Bm, Cm hold bf16 values."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc, L = S // chunk, chunk
    xc = x.reshape(Bsz, nc, L, H, P)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bc, Cc = Bm.reshape(Bsz, nc, L, N), Cm.reshape(Bsz, nc, L, N)
    sg = seg.reshape(Bsz, nc, L, H)
    dyc = dy.reshape(Bsz, nc, L, H, P)
    dsg = dseg.reshape(Bsz, nc, L, H)
    up = torch.ones(L, L, dtype=torch.bool).triu()          # t >= s
    bct = torch.einsum("bcsn,bctn->bcst", Bc, Cc)           # (s, t)
    E = torch.exp((sg[:, :, None] - sg[:, :, :, None]).masked_fill(
        ~up[:, :, None], -math.inf))                        # (b,c,s,t,h)
    bce = bct[..., None] * E
    G = bce * dtc[:, :, :, None]
    dg = _mm2("bcshp,bcthp->bcsth", xc, dyc, split) * up[:, :, None]
    cold = (dg * bce).sum(3)                                # (b,c,s,h)
    R = dg * G
    rowr = R.sum(2)                                         # (b,c,t,h)
    dcb = dg * E * dtc[:, :, :, None]
    ew = torch.exp(sg[:, :, -1:] - sg)
    W = ew * dtc
    Q = _mm2("bcsn,bchpn->bcshp", Bc, dK, split)
    dx = W[..., None] * Q + _mm3("bcsth,bcthp->bcshp", G, dyc, split)
    xdk = _mm2("bcshp,bchpn->bcshn", xc, dK, split)
    dW = torch.einsum("bcsn,bcshn->bcsh", Bc, xdk)
    db1 = W[..., None] * xdk
    sdcb = sum(dcb[..., h0:h0 + group].sum(-1) for h0 in range(0, H, group))
    sdb1 = sum(db1[:, :, :, h0:h0 + group].sum(3)
               for h0 in range(0, H, group))
    dC = _mm2("bcsn,bcst->bctn", Bc, sdcb, split)
    dB = sdb1 + _mm2("bctn,bcst->bcsn", Cc, sdcb, split)
    gs = dsg + rowr - dtc * cold - dW * W
    last = (dW * W).sum(2) + dtotal * torch.exp(sg[:, :, -1])
    gs = torch.cat([gs[:, :, :-1], gs[:, :, -1:] + last[:, :, None]], dim=2)
    rc = torch.flip(torch.cumsum(torch.flip(gs, (2,)), dim=2), (2,))
    ddt = cold + dW * ew + rc * A
    dA = (rc * dtc).sum((0, 1, 2))
    return (dx.reshape(Bsz, S, H, P), ddt.reshape(Bsz, S, H), dA,
            dB.reshape(Bsz, S, N), dC.reshape(Bsz, S, N))


def _bf16_inputs(rng, B, S, H, P, N, chunk, pad=0):
    """K4's inputs with x, Bm, Cm rounded to bf16 (held in float32), K4's
    plain seg, and float32 cotangents of its four outputs."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        _inputs(rng, B, S, H, P, N, pad))
    x, Bm, Cm = (t.to(torch.bfloat16).float() for t in (x, Bm, Cm))
    seg = tref.ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)[3]
    nc = S // chunk
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((B, S, H, P), (B, nc, H, P, N), (B, nc, H), (B, S, H))]
    return (x, dt, A, Bm, Cm, seg), cot


def _rel(got, want):
    return {n: float((g - w).abs().max() / w.abs().max())
            for n, g, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want)}


@pytest.mark.parametrize("B,S,H,P,N,chunk,pad", [
    (8, 128, 32, 64, 128, 128, 0),   # mamba2-370m training: group 1
    (8, 128, 80, 64, 64, 128, 0),    # zamba2-2.7b training: group 3
    (100, 32, 5, 24, 40, 32, 20),    # group 4 of 5, N and P off 16
])
def test_k4b_emulation_matches_plain(B, S, H, P, N, chunk, pad):
    """K4b's precision plan on the CPU before the card sees it: the bf16
    body's algebra (C.B^T once, the group sums of dCB and of dB's first
    term, 3xTF32 with two products where the other operand is bf16)
    against ssd_chunk_bwd_ref at the group ``bwd_head_group`` picks, every
    gradient within 1e-4 of its max, the limit the card holds the kernel
    to; plain TF32 (no lo half) misses it."""
    rng = np.random.default_rng(B + H)
    ins, cot = _bf16_inputs(rng, B, S, H, P, N, chunk, pad)
    group = tssdb.bwd_head_group(B * (S // chunk), H)
    want = tref.ssd_chunk_bwd_ref(*ins, *cot, chunk)
    rel = _rel(_k4b_emulated(*ins, *cot, chunk, group), want)
    assert max(rel.values()) < 1e-4, rel
    plain = _rel(_k4b_emulated(*ins, *cot, chunk, group, split=False), want)
    assert max(plain.values()) > 1e-4, plain


class _EmulatedChunk(torch.autograd.Function):
    """ssd_chunk_ref forward, the emulated bf16 body as its backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, group):
        outs = tref.ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, outs[3])
        ctx.args = (chunk, group)
        return outs

    @staticmethod
    def backward(ctx, dy, dcontrib, dtotal, dseg):
        chunk, group = ctx.args
        return (*_k4b_emulated(*ctx.saved_tensors, dy, dcontrib, dtotal,
                               dseg, chunk, group), None, None)


@pytest.mark.parametrize("S,chunk,group", [(64, 16, 2), (37, 16, 3)])
def test_k4b_emulation_matches_jax_vjp(S, chunk, group):
    """The emulated bf16 body as the chunk backward of the port's
    ssd_scan_ref (the recurrence through autograd) against jax.vjp of the
    reference's ssd_scan_ref, on bf16-valued float32 inputs with a ragged
    S and an initial state: every gradient within 1e-4 of its max."""
    B, H, P, N = 2, 5, 16, 8
    rng = np.random.default_rng(S)
    xs = _inputs(rng, B, S, H, P, N)
    for i in (0, 3, 4):
        xs[i] = torch.from_numpy(xs[i]).to(torch.bfloat16).float().numpy()
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    dy = rng.normal(size=(B, S, H, P)).astype(np.float32)
    ds = rng.normal(size=(B, H, P, N)).astype(np.float32)

    def jfn(x, dt, A, Bm, Cm, st):
        return jref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                 init_state=st)
    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in xs + [s0]))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))

    tin = [torch.from_numpy(a).requires_grad_(True) for a in xs + [s0]]
    y, fin = tref.ssd_scan_ref(
        *tin[:5], chunk=chunk, init_state=tin[5],
        chunk_fn=lambda *a: _EmulatedChunk.apply(*a, group))
    torch.autograd.backward((y, fin), (torch.from_numpy(dy),
                                       torch.from_numpy(ds)))
    for name, t, w in zip(("x", "dt", "A", "Bm", "Cm", "init_state"), tin,
                          want):
        w = np.asarray(w, np.float32)
        rel = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert rel < 1e-4, (name, rel)
