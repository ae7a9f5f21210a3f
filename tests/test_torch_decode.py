"""The LM decode path on the NPU compile path (ROADMAP item 8) on the CPU,
against the JAX package: ``repro_torch.frontends.lm``, the causal kinds
of both device plans and ``repro_torch.api.DecodeSession``.

Mirrors ``tests/test_lm_compile.py`` at ``lm.tiny_spec()``, with inputs
drawn with numpy from a seed:

  * the plain versions of K2 (with its ``q_offset`` at 0) and K3 against
    the Pallas kernels in interpret mode, atol 2e-5 / rtol 1e-4 (the
    reference test's tolerance);
  * the plan's attention at row offsets above 0 with several query rows
    (K2's ``q_offset``), its kvappend and its position decoding against
    ``core/ir.py`` of the reference, per lane of a ragged batch;
  * the decoder graphs and weights equal the reference's at every (seq,
    kv) bucket pair;
  * the float32 plan (``device="cpu"``) against the reference's plan and
    interpreter within ``executor.float_plan_tol``; the int8 plan's
    stored ints equal the reference plan's at these cases (0 ints differ:
    layernorm, gelu and the attention softmax are not piecewise linear,
    and torch sums in another order than numpy, so an int at a rounding
    boundary could move by one step, but none does here; on the card,
    where the kernels sum in their own order, ``chip_smoke.py`` allows
    one step and prints the count);
  * ``DecodeSession(device="cpu")``'s greedy tokens equal
    ``repro.api.DecodeSession``'s over 40 tokens at both precisions, and
    the reference's serving checks (isolation, plan reuse, bucket
    growth) hold.
"""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core.ir import _attention_ref, _kvappend_ref, _pos_index
from repro.frontends import lm as jlm
from repro_torch.core.execplan import attend, kv_append, pos_rows
from repro_torch.core.executor import float_plan_tol
from repro_torch.frontends import lm
from repro_torch.kernels import ops

SPEC = lm.tiny_spec()
JSPEC = jlm.tiny_spec()
# (seq, kv, pos) of the reference's engine-parity cases
CASES = ((8, 16, 0), (1, 8, 0), (1, 16, 5), (1, 16, 15))
# (plan capacity, requests): batch 1 and a ragged 3 in a 4-plan
BATCHES = ((1, 1), (4, 3))
PAIRS = [(s, kv) for kv in lm.SEQ_BUCKETS for s in (1,) + lm.SEQ_BUCKETS
         if s <= kv]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: its CPU work is small,
    and the suite runs files side by side, some of them timing-sensitive
    (the reference's deadline and tracing-overhead tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _heads(x, heads, hd):
    """(S, 1, d) -> (1, heads, S, hd) kernel layout."""
    s = x.shape[0]
    return x.reshape(s, heads, hd).transpose(1, 0, 2)[None]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# K2 and K3 plain versions against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("S", [4, 8, 16])
def test_k2_plain_with_zero_offset_matches_pallas(S):
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(S)
    heads, hd = 4, 8
    q, k, v = (_heads(rng.normal(size=(S, 1, heads * hd))
                      .astype(np.float32), heads, hd) for _ in range(3))
    scale = 1.0 / np.sqrt(hd)
    want = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      sm_scale=float(scale),
                                      interpret=True))
    for off in (None, torch.zeros(1, dtype=torch.int32)):
        got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                  sm_scale=float(scale), q_offset=off)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("pos", [0, 3, 7, 14])
def test_k3_plain_matches_pallas_positions(pos):
    import jax.numpy as jnp

    from repro.kernels.flash_decode import flash_decode

    rng = np.random.default_rng(100 + pos)
    heads, hd, kv = 4, 8, 16
    d = heads * hd
    q = rng.normal(size=(1, heads, hd)).astype(np.float32)
    kc = np.zeros((kv, 1, d), np.float32)
    vc = np.zeros((kv, 1, d), np.float32)
    kc[:pos + 1] = rng.normal(size=(pos + 1, 1, d))
    vc[:pos + 1] = rng.normal(size=(pos + 1, 1, d))
    k, v = _heads(kc, heads, hd), _heads(vc, heads, hd)
    scale = 1.0 / np.sqrt(hd)
    want = np.asarray(flash_decode(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   kv_len=jnp.asarray([pos + 1], jnp.int32),
                                   sm_scale=float(scale), interpret=True))
    got = ops.flash_decode(_t(q), _t(k), _t(v),
                           kv_len=torch.tensor([pos + 1]),
                           sm_scale=float(scale))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# the plan's causal helpers against core/ir.py of the reference
# --------------------------------------------------------------------------


def _lanes(rng, n, s, kv, d, positions):
    q = rng.normal(size=(n, s, 1, d)).astype(np.float32)
    kc = rng.normal(size=(n, kv, 1, d)).astype(np.float32)
    vc = rng.normal(size=(n, kv, 1, d)).astype(np.float32)
    pos = np.asarray(positions, np.float32).reshape(n, 1, 1, 1)
    return q, kc, vc, pos


@pytest.mark.parametrize("s,causal", [(2, True), (4, True), (4, False),
                                      (8, True)])
def test_attention_at_row_offsets_matches_reference(s, causal):
    """Lanes at different positions, several query rows each: the plan's
    attention (K2's plain version with ``q_offset``) against the
    reference's ``_attention_ref`` lane by lane, and K2's plain version
    called directly."""
    rng = np.random.default_rng(7 * s + causal)
    heads, hd, kv = 4, 8, 16
    positions = [0, 3, kv - s, 100]            # the last one clamps
    q, kc, vc, pos = _lanes(rng, 4, s, kv, heads * hd, positions)
    attrs = {"heads": heads, "head_dim": hd, "scale": float(hd ** -0.5),
             "causal": causal, "kv_len": kv}
    p0 = pos_rows(_t(pos), kv, s)
    assert p0.tolist() == [_pos_index(pos[b], kv, s) for b in range(4)]
    got = attend(_t(q), _t(kc), _t(vc), p0, attrs).numpy()
    for b in range(4):
        want = _attention_ref(q[b], kc[b], vc[b], pos[b], attrs)
        np.testing.assert_allclose(got[b].reshape(want.shape), want,
                                   atol=2e-5, rtol=1e-4)
    # the plain version's mask, row by row: j < off + S, j <= off + i
    qh = _t(q).view(4, s, heads, hd).transpose(1, 2)
    kh = _t(kc).view(4, kv, heads, hd).transpose(1, 2)
    vh = _t(vc).view(4, kv, heads, hd).transpose(1, 2)
    o = ops.flash_attention(qh, kh, vh, causal=causal,
                            sm_scale=attrs["scale"], q_offset=p0)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), got, atol=1e-6)


def test_pos_rows_rounds_and_clamps_as_the_reference():
    pos = np.array([0.0, 2.5, 3.5, 6.49, -3.0, 1e6, 14.0],
                   np.float32).reshape(-1, 1, 1, 1)
    for smax, s in ((16, 1), (16, 8), (8, 8)):
        got = pos_rows(_t(pos), smax, s).tolist()
        assert got == [_pos_index(p, smax, s) for p in pos]


def test_kv_append_matches_reference_per_lane():
    rng = np.random.default_rng(5)
    n, kv, s, d = 3, 16, 4, 12
    cache = rng.normal(size=(n, kv, 1, d)).astype(np.float32)
    new = rng.normal(size=(n, s, 1, d)).astype(np.float32)
    pos = np.array([0, 7, 15], np.float32).reshape(n, 1, 1, 1)
    out = torch.zeros((n, kv, 1, d))
    kv_append(out, _t(cache), _t(new), pos_rows(_t(pos), kv, s))
    for b in range(n):
        np.testing.assert_array_equal(
            out[b].numpy(), _kvappend_ref(cache[b], new[b], pos[b]))


# --------------------------------------------------------------------------
# the frontend: graphs and weights equal the reference's
# --------------------------------------------------------------------------


def test_spec_and_buckets_equal_reference():
    assert lm.SEQ_BUCKETS == jlm.SEQ_BUCKETS
    assert SPEC == lm.LMSpec(**vars(JSPEC))
    full = lm.tiny_spec(scale=1, n_layers=4, vocab=51865)
    assert (full.d_model, full.n_heads, full.head_dim, full.d_ff) == \
        (384, 6, 64, 1536)
    for n in range(1, 130):
        assert lm.bucket_for(n) == jlm.bucket_for(n)
    np.testing.assert_array_equal(lm.embedding_table(SPEC, 3),
                                  jlm.embedding_table(JSPEC, 3))


@pytest.mark.parametrize("seq,kv", PAIRS)
def test_build_decoder_equals_reference(seq, kv):
    g, b = lm.build_decoder(SPEC, seq, kv)
    gj, bj = jlm.build_decoder(JSPEC, seq, kv)
    assert g.fingerprint() == gj.fingerprint()
    assert lm.cache_io(g) == jlm.cache_io(gj)
    assert lm.logits_name(g) == jlm.logits_name(gj)
    assert set(b._weights) == set(bj._weights)
    for name, w in bj._weights.items():
        np.testing.assert_array_equal(b._weights[name], w)


# --------------------------------------------------------------------------
# the plans against the reference's
# --------------------------------------------------------------------------


def _feeds(g, n, positions, seed=0):
    """Inputs of ``n`` lanes at the given positions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    feed = {}
    for t in g.inputs:
        if t.name == "pos":
            feed[t.name] = np.asarray(positions[:n], np.float32) \
                .reshape(n, 1, 1, 1)
        else:
            feed[t.name] = rng.normal(size=(n,) + t.shape) \
                .astype(np.float32)
    return feed


def _positions(pos, n):
    """Lane 0 at ``pos``; a ragged batch also at 0 and at a later row."""
    return [pos, 0, pos + 1][:n]


@pytest.fixture(scope="module")
def models():
    """{(precision, seq, kv): (reference model, port model)}."""
    cache = {}

    def get(precision, seq, kv):
        key = (precision, seq, kv)
        if key not in cache:
            cache[key] = (
                jlm.compile_decoder(JSPEC, seq, kv, precision=precision,
                                    cache=False),
                lm.compile_decoder(SPEC, seq, kv, precision=precision,
                                   cache=False, device="cpu"))
        return cache[key]
    return get


@pytest.mark.parametrize("cap,n", BATCHES)
@pytest.mark.parametrize("seq,kv,pos", CASES)
def test_float32_plan_matches_reference(models, seq, kv, pos, cap, n):
    mj, mt = models("float32", seq, kv)
    feed = _feeds(mt.graph, n, _positions(pos, n), seed=seq + kv + pos)
    want = mj.plan_for(cap).run(feed, n=n)
    got = mt.plan_for(cap).run(feed, n=n)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= float_plan_tol(w), (name, err, float_plan_tol(w))
    # and the interpreter, lane by lane
    for b in range(n):
        one = {k: v[b] for k, v in feed.items()}
        interp = mt(one, engine="interp")
        for name, w in interp.items():
            w = w.numpy()
            err = float(np.abs(got[name][b].numpy() - w).max())
            assert err <= float_plan_tol(w), (name, b, err)


@pytest.mark.parametrize("cap,n", BATCHES)
@pytest.mark.parametrize("seq,kv,pos", CASES)
def test_int8_plan_ints_match_reference(models, seq, kv, pos, cap, n):
    mj, mt = models("int8", seq, kv)
    g = mt.graph
    for t in g.tensors.values():             # the same PTQ on both sides
        assert repr(t.qparams) == repr(mj.graph.tensors[t.name].qparams), \
            t.name
    feed = _feeds(g, n, _positions(pos, n), seed=seq + kv + pos)
    want = mj.plan_for(cap).run(feed, n=n, decode=False)
    got = mt.plan_for(cap).run(feed, n=n, decode=False)
    for name, w in want.items():
        gi = got[name].numpy()
        assert gi.dtype == np.int8 and np.array_equal(gi, w), \
            (name, int((gi != w).sum()))


def test_int8_decode_verifies_and_pos_stays_float(models):
    _, m = models("int8", 1, 16)
    g = m.graph
    assert g.tensors["pos"].dtype == "float32"
    assert g.tensors["pos"].qparams is None
    feed = {k: v[0] for k, v in _feeds(g, 1, [7]).items()}
    assert m.verify(feed).ok
    for op in g.ops:
        if op.kind == "kvappend":
            qi = g.tensors[op.inputs[0]].qparams
            qo = g.tensors[op.outputs[0]].qparams
            assert qi is not None and qi == qo


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_decode_step_reads_nothing_back(models, monkeypatch, precision):
    """A decode step's plan runs without a device-to-host read: every
    way of taking a tensor's value to the host raises inside it."""
    _, m = models(precision, 1, 16)
    feed = {k: torch.from_numpy(v)
            for k, v in _feeds(m.graph, 3, [5, 0, 9]).items()}
    plan = m.plan_for(4)
    plan.run(feed, n=3)                       # warm

    def refuse(*a, **k):
        raise AssertionError("a plan step read a tensor back to the host")
    for attr in ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    for st in plan.steps:
        st.run(plan._views, 3)


# --------------------------------------------------------------------------
# DecodeSession against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_greedy_tokens_equal_reference_over_40_tokens(precision):
    want = japi.DecodeSession(precision=precision).generate(
        [3, 17, 42], max_new_tokens=40)
    sess = tapi.DecodeSession(precision=precision, device="cpu")
    got = sess.generate([3, 17, 42], max_new_tokens=40)
    assert got == want
    # 3 + 40 tokens cross kv 8 -> 16 -> 32 -> 64, each plan built once
    assert set(sess.stats()) == {"s8/kv8", "s1/kv8", "s1/kv16", "s1/kv32",
                                 "s1/kv64"}
    assert all(s["plan"]["builds"] == 1 for s in sess.stats().values())


def test_kv_cache_isolation_across_concurrent_requests():
    prompt_a, prompt_b = [3, 17, 42, 5], [9, 1, 88]
    solo = tapi.DecodeSession(device="cpu")
    a_solo = solo.generate(prompt_a, max_new_tokens=4)
    b_solo = solo.generate(prompt_b, max_new_tokens=4)

    sess = tapi.DecodeSession(device="cpu")
    ra, ta = sess.prefill(prompt_a)
    rb, tb = sess.prefill(prompt_b)
    a, b = [ta], [tb]
    for _ in range(3):          # interleave the two decode loops
        a.append(sess.step(ra))
        b.append(sess.step(rb))
    assert a == a_solo
    assert b == b_solo
    assert sorted(sess.active_requests()) == sorted([ra, rb])
    assert sess.tokens(ra) == prompt_a + a
    sess.finish(ra)
    sess.finish(rb)
    assert sess.active_requests() == []


def test_decode_plan_built_once_then_hit():
    sess = tapi.DecodeSession(device="cpu")
    sess.generate([2, 4, 6], max_new_tokens=4)   # prefill + 3 steps
    st = sess.stats()
    assert set(st) == {"s8/kv8", "s1/kv8"}
    for s in st.values():                        # zero re-lowering
        assert s["plan"]["builds"] == 1
    assert st["s1/kv8"]["plan"]["hits"] == 2     # steps after the first


def test_weights_shared_across_buckets():
    _, b1 = lm.build_decoder(SPEC, 1, 8)
    _, b2 = lm.build_decoder(SPEC, 8, 16)
    _, b3 = lm.build_decoder(SPEC, 1, 128)
    assert set(b1._weights) == set(b2._weights) == set(b3._weights)
    for name, w in b1._weights.items():
        np.testing.assert_array_equal(w, b2._weights[name])
        np.testing.assert_array_equal(w, b3._weights[name])


def test_bucket_growth_mid_generation():
    sess = tapi.DecodeSession(buckets=(8, 16), device="cpu")
    rid, _ = sess.prefill([1, 2, 3, 4, 5, 6])    # pos 6 in kv8
    toks = [sess.step(rid) for _ in range(4)]    # crosses 8 -> 16
    assert len(toks) == 4
    r = sess._requests[rid]
    assert r.bucket == 16 and r.pos == 10
    assert all(c.shape == (16, 1, SPEC.d_model) for c in r.caches.values())
    assert {"s8/kv8", "s1/kv8", "s1/kv16"} <= set(sess.stats())
    want = japi.DecodeSession(buckets=(8, 16)).generate(
        [1, 2, 3, 4, 5, 6], max_new_tokens=5)
    assert [sess.tokens(rid)[6]] + toks == want


def test_session_refuses_bad_prompts_and_needs_a_device(monkeypatch):
    sess = tapi.DecodeSession(device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        sess.prefill([])
    with pytest.raises(ValueError, match="prompt ids"):
        sess.prefill([SPEC.vocab])
    with pytest.raises(ValueError, match="largest KV bucket"):
        sess.prefill(list(range(1, 90)) * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.DecodeSession()


def test_trace_spans_follow_one_request():
    from repro_torch.obs import trace
    sess = tapi.DecodeSession(buckets=(8, 16), device="cpu")
    with trace.session() as tr:
        sess.generate([1, 2, 3, 4, 5, 6, 7], max_new_tokens=3)
    names = [e[0] for e in tr.events()]       # (name, cat, ..., trace_id,
    assert names.count("lm.prefill") == 1     # args)
    assert names.count("lm.decode_step") == 2
    assert names.count("lm.bucket_grow") == 1
    assert names.count("lm.compile") == 3
    ids = {e[6] for e in tr.events()
           if e[0] in ("lm.prefill", "lm.decode_step", "lm.bucket_grow")}
    assert len(ids) == 1 and None not in ids
