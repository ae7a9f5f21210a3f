"""The port's SSM and hybrid slice on the CPU against the JAX package.

K4's plain version (``ref.ssd_chunk_ref``) is held against the Pallas
``ssd_chunk`` in interpret mode, as ``tests/test_kernels.py`` runs it;
``ops.ssd_scan``, ``ssd_step`` and ``ssm_block`` against their JAX
counterparts; mamba2-370m and zamba2-2.7b (reduced) against
``repro.models.lm`` with the JAX weights carried across by
``params_from_numpy``.  Inputs come from numpy with a fixed seed.

Tolerances: kernels atol 2e-3 / rtol 1e-3 in float32 (both sides sum
the chunk's products in f32, in different orders); models atol/rtol
2e-4 in float32; bfloat16 5e-2 (both round activations and the decode
state to bf16, at different places): atol/rtol for one block, relative
to max|logit| for whole models.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk as j_ssd_chunk
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.registry import get_arch as jget_arch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.launch.serve import generate
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.registry import get_arch as tget_arch
from test_torch_lm import _jax_greedy, _np

K_TOL = dict(atol=2e-3, rtol=1e-3)
F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def _ssd_inputs(seed, B, S, H, P, N, dt_hi=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, dt_hi, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------
# K4: ssd_chunk's plain version against the Pallas kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,P,N,chunk,pad", [
    (1, 32, 1, 8, 4, 8, 0),
    (2, 128, 3, 16, 8, 32, 0),
    (2, 128, 2, 32, 16, 32, 28),       # ragged S=100 padded as ops does
    (1, 48, 3, 8, 24, 16, 5),          # N > P, a ragged last chunk
])
def test_ssd_chunk_ref_matches_pallas(B, S, H, P, N, chunk, pad):
    x, dt, A, Bm, Cm = _ssd_inputs(S + P + N, B, S, H, P, N)
    if pad:          # the zero rows ops.ssd_scan appends (dt = 0 there)
        for a in (x, dt, Bm, Cm):
            a[:, S - pad:] = 0
    want = j_ssd_chunk(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
                       interpret=True)
    got = tref.ssd_chunk_ref(*_t(x, dt, A, Bm, Cm), chunk)
    nc = S // chunk
    shapes = [(B, S, H, P), (B, nc, H, P, N), (B, nc, H), (B, S, H)]
    for g, w, shape in zip(got, want, shapes):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **K_TOL)


def test_ssd_chunk_ref_has_no_overflow_above_the_diagonal():
    """Large dt*|A| makes exp(seg_t - seg_s) overflow for s > t; the gate
    is masked before the exp, so every output stays finite."""
    x, dt, A, Bm, Cm = _ssd_inputs(7, 1, 64, 2, 8, 8)
    dt[:] = 5.0
    outs = tref.ssd_chunk_ref(*_t(x, dt, A, Bm, Cm), 64)
    assert all(torch.isfinite(o).all() for o in outs[:3])


def test_ssd_chunk_ref_rejects_ragged_s():
    x, dt, A, Bm, Cm = _ssd_inputs(8, 1, 30, 1, 8, 4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tref.ssd_chunk_ref(*_t(x, dt, A, Bm, Cm), 16)


# --------------------------------------------------------------------------
# ops.ssd_scan / ssd_step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,P,N,chunk,init", [
    (1, 32, 1, 8, 4, 8, False),
    (2, 128, 3, 16, 8, 32, False),
    (2, 100, 2, 32, 16, 32, False),     # ragged S
    (2, 37, 3, 16, 8, 16, True),        # ragged S, initial state
])
def test_ssd_scan_matches_jax(B, S, H, P, N, chunk, init):
    x, dt, A, Bm, Cm = _ssd_inputs(S * H, B, S, H, P, N)
    s0 = (np.random.default_rng(1).normal(size=(B, H, P, N))
          .astype(np.float32) if init else None)
    jargs = list(map(jnp.asarray, (x, dt, A, Bm, Cm)))
    got_y, got_s = tops.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                                 init_state=None if s0 is None
                                 else torch.from_numpy(s0))
    assert got_y.shape == (B, S, H, P) and got_s.shape == (B, H, P, N)
    for impl in ("pallas", "ref"):
        want_y, want_s = jops.ssd_scan(*jargs, chunk=chunk, impl=impl,
                                       init_state=None if s0 is None
                                       else jnp.asarray(s0))
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   **K_TOL)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   **K_TOL)
    # impl="ref" and the plain path on a CPU tensor are one computation
    ref_y, _ = tops.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                             init_state=None if s0 is None
                             else torch.from_numpy(s0), impl="ref")
    torch.testing.assert_close(ref_y, got_y, atol=0, rtol=0)


def test_ssd_chunked_equals_stepwise():
    """Chunked scan == token-by-token recurrence through the port's
    ssd_step (the prefill/decode parity of the SSM layers)."""
    B, S, H, P, N = 2, 48, 2, 8, 8
    x, dt, A, Bm, Cm = _ssd_inputs(3, B, S, H, P, N, dt_hi=0.2)
    x_t, dt_t, A_t, B_t, C_t = _t(x, dt, A, Bm, Cm)
    y, s_final = tops.ssd_scan(x_t, dt_t, A_t, B_t, C_t, chunk=16)
    state = torch.zeros(B, H, P, N)
    ys = []
    for t in range(S):
        yt, state = tops.ssd_step(state, x_t[:, t], dt_t[:, t], A_t,
                                  B_t[:, t], C_t[:, t])
        ys.append(yt)
    torch.testing.assert_close(torch.stack(ys, 1), y, atol=5e-3, rtol=1e-2)
    torch.testing.assert_close(state, s_final, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_step_matches_jax(dtype):
    B, H, P, N = 2, 3, 8, 4
    rng = np.random.default_rng(4)
    state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(B, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, N)).astype(np.float32) for _ in range(2))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jref.ssd_step_ref(jnp.asarray(state, jd), jnp.asarray(x, jd),
                             jnp.asarray(dt), jnp.asarray(A),
                             jnp.asarray(Bm, jd), jnp.asarray(Cm, jd))
    got = tops.ssd_step(*(torch.from_numpy(a).to(td)
                          for a in (state, x)), *_t(dt, A),
                        *(torch.from_numpy(a).to(td) for a in (Bm, Cm)))
    tol = K_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got, want):
        assert g.dtype == td          # a bf16 state stays bf16
        np.testing.assert_allclose(_np(g), _np(w), **tol)


# --------------------------------------------------------------------------
# ssm_block
# --------------------------------------------------------------------------


def _ssm_pair(dtype="float32", seed=0):
    cfg_j = jget_arch("mamba2-370m").reduced(dtype=dtype)
    cfg_t = tget_arch("mamba2-370m").reduced(dtype=dtype)
    p = jssm.init_ssm(jax.random.PRNGKey(seed), cfg_j, jnp.dtype(dtype))
    rng = np.random.default_rng(seed)
    # nonzero A_log, dt_bias and gnorm, so every parameter is exercised
    H = cfg_j.ssm_heads
    p["A_log"] = jnp.asarray(rng.uniform(-1, 1, H), jnp.float32)
    p["dt_bias"] = jnp.asarray(rng.uniform(-1, 1, H), jnp.float32)
    p["gnorm"] = jnp.asarray(rng.normal(size=cfg_j.d_inner) * 0.1,
                             jnp.dtype(dtype))
    mod = tssm.SSM(cfg_t, getattr(torch, dtype), "cpu")
    with torch.no_grad():
        for name, leaf in p.items():
            getattr(mod, name).copy_(tensor_from_numpy(np.asarray(leaf),
                                                       "cpu"))
    return cfg_j, cfg_t, p, mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_full_sequence_matches_jax(dtype):
    cfg_j, cfg_t, p, mod = _ssm_pair(dtype)
    h = np.random.default_rng(5).normal(size=(2, 37, cfg_j.d_model))
    want, _ = jssm.ssm_block(p, jnp.asarray(h, jnp.dtype(dtype)), cfg_j)
    got, st = tssm.ssm_block(mod, torch.from_numpy(h).to(
        getattr(torch, dtype)), cfg_t)
    assert st is None and got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_decode_matches_jax(dtype):
    cfg_j, cfg_t, p, mod = _ssm_pair(dtype)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    B, steps = 2, 6
    hs = np.random.default_rng(6).normal(size=(steps, B, 1, cfg_j.d_model))
    sj = jssm.init_ssm_state(cfg_j, B, jd)
    st = tssm.init_ssm_state(cfg_t, B, td, "cpu")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in range(steps):
        yj, sj = jssm.ssm_block(p, jnp.asarray(hs[t], jd), cfg_j, state=sj)
        yt, st = tssm.ssm_block(mod, torch.from_numpy(hs[t]).to(td), cfg_t,
                                state=st)
        np.testing.assert_allclose(_np(yt), _np(yj), **tol)
    assert st.ssd.dtype == td and st.conv.dtype == td
    np.testing.assert_allclose(_np(st.conv), _np(sj.conv), **tol)
    np.testing.assert_allclose(_np(st.ssd), _np(sj.ssd), **tol)


# --------------------------------------------------------------------------
# mamba2-370m and zamba2-2.7b (reduced) against repro.models.lm
# --------------------------------------------------------------------------

ARCHS = ("mamba2-370m", "zamba2-2.7b")


def _lm_pair(arch, dtype="float32", seed=0, **overrides):
    cfg_j = jget_arch(arch).reduced(dtype=dtype, **overrides)
    cfg_t = tget_arch(arch).reduced(dtype=dtype, **overrides)
    params = jlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    if cfg_j.family == "hybrid":
        # the JAX init zeroes q_b and in_b; give them values so that the
        # LoRA deltas are exercised
        rng = np.random.default_rng(seed)
        lora = dict(params["groups"]["lora"])
        for w in ("q_b", "in_b"):
            lora[w] = jnp.asarray(rng.normal(size=lora[w].shape) * 0.05,
                                  lora[w].dtype)
        params = dict(params, groups=dict(params["groups"], lora=lora))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg_j, cfg_t, params, params_from_numpy(cfg_t, tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _lm_pair(request.param)


def test_configs_are_copies():
    for arch in ARCHS:
        j, t = jget_arch(arch), tget_arch(arch)
        assert j.__dict__ == t.__dict__
        assert t.reduced().__dict__ == j.reduced().__dict__
    z = tget_arch("zamba2-2.7b")
    assert (z.n_layers, z.d_model, z.ssm_heads, z.head_dim) == \
        (54, 2560, 80, 80)


def test_forward_matches_jax(pair):
    cfg_j, cfg_t, params, model = pair
    tokens = np.random.default_rng(1).integers(
        0, cfg_j.vocab, size=(2, 21)).astype(np.int32)
    want = jlm.forward(cfg_j, params, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward(cfg_t, model, {"tokens": tokens})
    assert got.shape == (2, 21, cfg_t.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        _np(tlm.prefill(cfg_t, model, {"tokens": tokens})),
        _np(want)[:, -1], **F32_TOL)


def _cache_leaves(cfg, cache):
    if cfg.family == "hybrid":
        return [cache["ssm"].conv, cache["ssm"].ssd, cache["shared"]["k"],
                cache["shared"]["v"]]
    return [cache["ssm"].conv, cache["ssm"].ssd]


def test_decode_steps_match_jax(pair):
    cfg_j, cfg_t, params, model = pair
    B, steps = 2, 8
    tokens = np.random.default_rng(2).integers(
        0, cfg_j.vocab, size=(B, steps)).astype(np.int32)
    step = jax.jit(partial(jlm.decode_step, cfg_j))
    cj = jlm.init_cache(cfg_j, B, steps)
    ct = tlm.init_cache(cfg_t, B, steps, device="cpu")
    for t in range(steps):
        lj, cj = step(params, cj, jnp.asarray(tokens[:, t]), jnp.int32(t))
        lt, ct = tlm.decode_step(cfg_t, model, ct, tokens[:, t], t)
        np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
    for got, want in zip(_cache_leaves(cfg_t, ct), _cache_leaves(cfg_j, cj)):
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_decode_replay_matches_forward(pair):
    """The decode replay at position P-1 equals the full-sequence forward
    at its last position: ssd_step against the chunked scan (and, in
    zamba2's shared blocks, flash_decode against flash_attention)."""
    _, cfg_t, _, model = pair
    prompts = np.random.default_rng(3).integers(
        0, cfg_t.vocab, size=(2, 19)).astype(np.int32)
    res = generate(cfg_t, model, prompts, gen=1)
    np.testing.assert_allclose(
        _np(res.prompt_logits),
        _np(tlm.prefill(cfg_t, model, {"tokens": prompts})), **F32_TOL)


def test_generate_matches_jax_greedy(pair):
    cfg_j, cfg_t, params, model = pair
    prompts = np.random.default_rng(0).integers(
        0, cfg_j.vocab, size=(2, 6)).astype(np.int32)
    want, chooser = _jax_greedy(cfg_j, params, prompts, gen=8)
    res = generate(cfg_t, model, prompts, gen=8)
    assert res.tokens.shape == (2, 8) and res.logits_finite
    # Compare tokens up to the first step whose top two logits lie within
    # 1e-4 (a near tie either side may break differently).
    n = 8
    for i, lg in enumerate(chooser):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if np.any(top2[:, 1] - top2[:, 0] < 1e-4):
            n = i
            break
    np.testing.assert_array_equal(res.tokens[:, :n], want[:, :n])
    np.testing.assert_allclose(_np(res.prompt_logits), chooser[0],
                               **F32_TOL)


def _rel(got, want):
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


# zamba2 at two groups: at six, the JAX package's own bf16 logits lie
# farther than 5e-2 of max|logit| from its float32 ones, so the
# comparison would measure rounding noise.
@pytest.mark.parametrize("arch,overrides", [
    ("mamba2-370m", {}), ("zamba2-2.7b", dict(n_layers=4))])
def test_bf16_forward_and_decode_match_jax(arch, overrides):
    """bf16 logits against the JAX package's, as max|d|/max|logit| < 5e-2
    (the measure of chip_smoke.py): both round every layer to bf16 at
    different places, so single elements differ by more than 5e-2."""
    cfg_j, cfg_t, params, model = _lm_pair(arch, dtype="bfloat16",
                                           **overrides)
    assert model.embed.dtype == torch.bfloat16
    tokens = np.random.default_rng(4).integers(
        0, cfg_j.vocab, size=(2, 18)).astype(np.int32)
    want = jlm.forward(cfg_j, params, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward(cfg_t, model, {"tokens": tokens})
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 5e-2
    # decode keeps its SSM state in bf16, as the JAX package does
    step = jax.jit(partial(jlm.decode_step, cfg_j))
    cj = jlm.init_cache(cfg_j, 2, 4)
    ct = tlm.init_cache(cfg_t, 2, 4, device="cpu")
    assert ct["ssm"].ssd.dtype == torch.bfloat16
    for t in range(4):
        lj, cj = step(params, cj, jnp.asarray(tokens[:, t]), jnp.int32(t))
        lt, ct = tlm.decode_step(cfg_t, model, ct, tokens[:, t], t)
        assert _rel(lt, lj) < 5e-2


@pytest.mark.parametrize("arch,change,bad", [
    ("mamba2-370m", dict(ssm_conv=3), "layers.0.ssm.conv_w"),
    ("zamba2-2.7b", dict(lora_rank=2), "groups.0.lora.q_a"),
    ("zamba2-2.7b", dict(dtype="bfloat16"), "embed"),
])
def test_params_from_numpy_rejects_wrong_shapes(arch, change, bad):
    cfg_j, cfg_t, params, _ = _lm_pair(arch)
    tree = jax.tree_util.tree_map(np.asarray, params)
    other = dataclasses.replace(cfg_t, **change)
    with pytest.raises(ValueError, match=f"{bad}: .* does not fit"):
        params_from_numpy(other, tree, "cpu")


def test_kernel_wrapper_checks_shapes_before_the_device():
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(9, 1, 30, 2, 8, 4))
    with pytest.raises(ValueError, match="multiple of chunk"):
        t_ssd.ssd_chunk(x, dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="do not match"):
        t_ssd.ssd_chunk(x, dt[:, :, :1], A, Bm, Cm, 15)
    with pytest.raises(ValueError, match="<= 128"):
        t_ssd.ssd_chunk(x, dt, A, Bm, Cm, 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_raise_without_a_gpu(monkeypatch, arch):
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget_arch(arch).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(arch, batch=1, prompt_len=2, gen=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_cache(cfg, 1, 4)
