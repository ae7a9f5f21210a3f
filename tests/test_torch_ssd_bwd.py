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
(both round the gradients of bf16 inputs to bf16).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


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
