"""whisper-tiny (encoder-decoder) and qwen2-vl-2b (M-RoPE, vision tokens)
of the port on the CPU against ``repro.models.lm``.

Each arch is reduced as the JAX tests reduce it (2 encoder and 2 decoder
layers over 32 audio frames; 2 layers and 8 vision tokens), and padded
(3 query heads over 1 kv head, padded to 4), so that ``_expand_kv`` and
``_mask_padded`` run as at full width, where both archs pad to 16 heads.
Weights come from the JAX ``init_params`` and are carried across with
``params_from_numpy``; tokens and the audio and vision embeddings come
from numpy with a fixed seed.  Tolerances, as ``tests/test_torch_lm.py``
states them: float32 atol/rtol 2e-4, bfloat16 atol/rtol 5e-2.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.registry import get_arch as jget_arch
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import decode_aux, draw_inputs, generate
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch as tget_arch

F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
PADDED = dict(n_heads=3, n_kv_heads=1, d_head=32, tp_pad=4)

VARIANTS = {
    "whisper": ("whisper-tiny", dict(dtype="float32")),
    "whisper-padded": ("whisper-tiny", dict(PADDED, dtype="float32")),
    "qwen2-vl": ("qwen2-vl-2b", dict(dtype="float32")),
    "qwen2-vl-padded": ("qwen2-vl-2b", dict(PADDED, dtype="float32")),
}
WHISPER = [v for v in VARIANTS if v.startswith("whisper")]
PROMPT = 12          # past qwen2-vl's 8 vision tokens


def _pair(arch, overrides, seed=0):
    cfg_j = jget_arch(arch).reduced(**overrides)
    cfg_t = tget_arch(arch).reduced(**overrides)
    params = jlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg_j, cfg_t, params, params_from_numpy(cfg_t, tree, "cpu")


_PAIRS = {}


def _cached_pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = _pair(*VARIANTS[name])
    return _PAIRS[name]


@pytest.fixture(params=list(VARIANTS))
def pair(request):
    return _cached_pair(request.param)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _inputs(cfg, seed, B=2, S=PROMPT):
    """Prompts and the family's embeddings, drawn as ``serve`` draws
    them."""
    return draw_inputs(cfg, np.random.default_rng(seed), B, S)


def _jbatch(prompts, extra):
    return {"tokens": jnp.asarray(prompts),
            **{k: jnp.asarray(v) for k, v in extra.items()}}


def _aux_pair(cfg_j, cfg_t, params, model, extra):
    """The decode steps' aux on both sides, each from its own encoder."""
    aux_t, _ = decode_aux(cfg_t, model, extra)
    if cfg_j.enc_dec:
        enc = jlm.encode_audio(cfg_j, params,
                               jnp.asarray(extra["audio_embed"]))
        return {"enc_states": enc,
                "cross_kv": jlm.cross_kv(cfg_j, params, enc)}, aux_t
    return {"vision_embed": jnp.asarray(extra["vision_embed"])}, aux_t


def _flat(cache):
    """(name, array) of every leaf of a cache dict, in sorted order; a
    None leaf (whisper's "cross") is left out."""
    out = []
    for key in sorted(cache):
        sub = cache[key]
        if isinstance(sub, dict):
            out += [(f"{key}.{n}", a) for n, a in _flat(sub)]
        elif sub is not None:
            out.append((key, sub))
    return out


def test_configs_are_copies():
    for arch in ("whisper-tiny", "qwen2-vl-2b"):
        j, t = jget_arch(arch), tget_arch(arch)
        assert j.__dict__ == t.__dict__
        assert t.reduced().__dict__ == j.reduced().__dict__
        assert t.reduced(**PADDED).__dict__ == j.reduced(**PADDED).__dict__
    assert tget_arch("whisper-tiny").padded_heads == 16
    assert tget_arch("qwen2-vl-2b").padded_heads == 16


@pytest.mark.parametrize("D,sections", [(128, (16, 24, 24)),
                                        (32, (8, 4, 4)), (64, (2, 20, 10))])
def test_apply_mrope_matches_jax_at_distinct_positions(D, sections):
    """Distinct t/h/w positions, so that each band's axis is decisive;
    with one position on all three axes M-RoPE is RoPE."""
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 7, 3, D)).astype(np.float32)
    pos3 = rng.integers(0, 500, size=(3, 2, 7))
    assert (pos3[0] != pos3[1]).any() and (pos3[1] != pos3[2]).any()
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    same = torch.from_numpy(np.broadcast_to(pos3[:1], pos3.shape).copy())
    np.testing.assert_allclose(
        tlayers.apply_mrope(torch.from_numpy(x), same, sections).numpy(),
        tlayers.apply_rope(torch.from_numpy(x), same[0]).numpy(), **F32_TOL)
    with pytest.raises(ValueError, match="do not sum"):
        tlayers.apply_mrope(torch.from_numpy(x), same, (1, 1, 1))


def test_forward_matches_jax(pair):
    cfg_j, cfg_t, params, model = pair
    prompts, extra = _inputs(cfg_j, 1)
    want = jlm.forward(cfg_j, params, _jbatch(prompts, extra))
    got = tlm.forward(cfg_t, model, {"tokens": prompts, **extra})
    assert got.shape == (2, PROMPT, cfg_t.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        _np(tlm.prefill(cfg_t, model, {"tokens": prompts, **extra})),
        _np(want)[:, -1], **F32_TOL)


@pytest.mark.parametrize("name", WHISPER)
def test_encode_audio_and_cross_kv_match_jax(name):
    cfg_j, cfg_t, params, model = _cached_pair(name)
    _, extra = _inputs(cfg_j, 4)
    audio = extra["audio_embed"]
    enc_j = jlm.encode_audio(cfg_j, params, jnp.asarray(audio))
    enc_t = tlm.encode_audio(cfg_t, model, audio)
    assert enc_t.shape == (2, cfg_t.n_audio_frames, cfg_t.d_model)
    np.testing.assert_allclose(_np(enc_t), _np(enc_j), **F32_TOL)
    kv_j = jlm.cross_kv(cfg_j, params, enc_j)
    kv_t = tlm.cross_kv(cfg_t, model, enc_t)
    for key in ("k", "v"):
        assert tuple(kv_t[key].shape) == (
            cfg_t.n_layers, 2, cfg_t.n_kv_heads, cfg_t.n_audio_frames,
            cfg_t.head_dim)
        np.testing.assert_allclose(_np(kv_t[key]), _np(kv_j[key]),
                                   **F32_TOL)


def test_decode_steps_match_jax(pair):
    """Logits and the self cache after each decode step, with the same
    aux on both sides (qwen2-vl's steps cross its last vision token)."""
    cfg_j, cfg_t, params, model = pair
    B, steps = 2, PROMPT
    prompts, extra = _inputs(cfg_j, 2, B, steps)
    aux_j, aux_t = _aux_pair(cfg_j, cfg_t, params, model, extra)
    step = jax.jit(partial(jlm.decode_step, cfg_j))
    cj = jlm.init_cache(cfg_j, B, steps + 2)
    ct = tlm.init_cache(cfg_t, B, steps + 2, device="cpu")
    assert ("cross" in ct) == bool(cfg_t.enc_dec)
    for t in range(steps):
        lj, cj = step(params, cj, jnp.asarray(prompts[:, t]), jnp.int32(t),
                      aux_j)
        lt, ct = tlm.decode_step(cfg_t, model, ct, prompts[:, t], t,
                                 aux=aux_t)
        np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
        got, want = _flat(ct), _flat(cj)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, a), (_, b) in zip(got, want):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(_np(a), _np(b), **F32_TOL,
                                       err_msg=f"{name} at step {t}")


def test_decode_replay_matches_forward(pair):
    """The decode replay at every prompt position equals the
    full-sequence forward there (``tests/test_archs.py:54-77``):
    ``decode_step`` rotates by RoPE, ``forward`` by M-RoPE."""
    cfg_j, cfg_t, params, model = pair
    prompts, extra = _inputs(cfg_t, 3)
    _, aux = _aux_pair(cfg_j, cfg_t, params, model, extra)
    full = tlm.forward(cfg_t, model, {"tokens": prompts, **extra})
    cache = tlm.init_cache(cfg_t, 2, PROMPT, device="cpu")
    for t in range(PROMPT):
        lg, cache = tlm.decode_step(cfg_t, model, cache, prompts[:, t], t,
                                    aux=aux)
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), **F32_TOL,
                                   err_msg=f"position {t}")
    res = generate(cfg_t, model, prompts, gen=1, aux=aux)
    np.testing.assert_allclose(_np(res.prompt_logits), _np(full[:, -1]),
                               **F32_TOL)


def test_generate_matches_jax_greedy(pair):
    """Greedy tokens of the port's serving loop equal the JAX decode
    loop's (repro/launch/serve.py:65-80) with the same aux, up to the
    first near tie."""
    cfg_j, cfg_t, params, model = pair
    B, P, gen = 2, PROMPT, 8
    prompts, extra = _inputs(cfg_j, 0, B, P)
    aux_j, aux_t = _aux_pair(cfg_j, cfg_t, params, model, extra)
    step = jax.jit(partial(jlm.decode_step, cfg_j))
    cache = jlm.init_cache(cfg_j, B, P + gen)
    for t in range(P):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, t]),
                             jnp.int32(t), aux_j)
    want, chooser = [], []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(P, P + gen):
        want.append(np.asarray(tok))
        chooser.append(np.asarray(logits, np.float32))
        logits, cache = step(params, cache, tok, jnp.int32(t), aux_j)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    res = generate(cfg_t, model, prompts, gen=gen, aux=aux_t)
    assert res.tokens.shape == (B, gen) and res.logits_finite
    n = gen
    for i, lg in enumerate(chooser):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if np.any(top2[:, 1] - top2[:, 0] < 1e-4):
            n = i
            break
    np.testing.assert_array_equal(res.tokens[:, :n],
                                  np.stack(want, axis=1)[:, :n])
    np.testing.assert_allclose(_np(res.prompt_logits), chooser[0],
                               **F32_TOL)


class _Recorder:
    """A numpy Generator that records what ``integers`` and ``normal``
    return."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def integers(self, *args, **kw):
        out = self._rng.integers(*args, **kw)
        self._log.append(out)
        return out

    def normal(self, *args, **kw):
        out = self._rng.normal(*args, **kw)
        self._log.append(out)
        return out


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-2b"])
def test_serve_draws_equal_the_reference(arch, monkeypatch):
    """For one seed, ``serve``'s prompts, audio and vision embeddings are
    the reference's: its draws are recorded while it serves."""
    from repro.launch import serve as jserve
    log = []
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: _Recorder(real(seed), log))
    jserve.serve(arch, batch=2, prompt_len=3, gen=1, seed=5)
    monkeypatch.undo()
    cfg = tget_arch(arch).reduced()
    prompts, extra = draw_inputs(cfg, np.random.default_rng(5), 2, 3)
    mine = [prompts] + list(extra.values())
    assert len(log) == len(mine) == 2
    for a, b in zip(log, mine):
        np.testing.assert_array_equal(a.astype(b.dtype), b)


def test_vision_tokens_past_the_prompt_raise():
    """S < Nv: the reference's dynamic_update_slice refuses it, and so
    does the port, instead of cutting the embeddings short."""
    cfg_j, cfg_t, params, model = _cached_pair("qwen2-vl")
    prompts, extra = _inputs(cfg_t, 6, S=cfg_t.n_vision_tokens - 1)
    with pytest.raises(Exception):
        jlm.forward(cfg_j, params, _jbatch(prompts, extra))
    with pytest.raises(ValueError, match="does not fit"):
        tlm.forward(cfg_t, model, {"tokens": prompts, **extra})
    # at S == Nv every position is a vision token
    prompts, extra = _inputs(cfg_t, 6, S=cfg_t.n_vision_tokens)
    np.testing.assert_allclose(
        _np(tlm.forward(cfg_t, model, {"tokens": prompts, **extra})),
        _np(jlm.forward(cfg_j, params, _jbatch(prompts, extra))),
        **F32_TOL)


def test_whisper_decode_step_needs_cross_kv():
    _, cfg_t, _, model = _cached_pair("whisper")
    cache = tlm.init_cache(cfg_t, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="cross_kv"):
        tlm.decode_step(cfg_t, model, cache, np.zeros(2, np.int32), 0)


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_params_from_numpy_carries_every_leaf(pair):
    cfg_j, cfg_t, params, model = pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    stacks = ("layers", "enc_layers", "dec_layers")
    n_params = sum(1 for _ in model.named_parameters())
    stacked = sum(a.shape[0] if path[0] in stacks else 1
                  for path, a in _leaf_paths(tree))
    assert n_params == stacked
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
    if cfg_t.enc_dec:
        assert set(tree) == {"embed", "final_norm", "enc_pos", "enc_layers",
                             "enc_norm", "dec_layers"}
        np.testing.assert_array_equal(model.enc_pos.numpy(),
                                      tree["enc_pos"])
        np.testing.assert_array_equal(
            model.dec_layers[1].xattn.wv.numpy(),
            tree["dec_layers"]["xattn"]["wv"][1])
        np.testing.assert_array_equal(
            model.dec_layers[0].norm3.numpy(),
            tree["dec_layers"]["norm3"][0])
        np.testing.assert_array_equal(
            model.enc_layers[1].mlp.w_out.numpy(),
            tree["enc_layers"]["mlp"]["w_out"][1])
    else:
        np.testing.assert_array_equal(model.layers[1].attn.wq.numpy(),
                                      tree["layers"]["attn"]["wq"][1])


def _with(tree, path, value):
    out = dict(tree)
    sub = out
    for k in path[:-1]:
        sub[k] = dict(sub[k])
        sub = sub[k]
    sub[path[-1]] = value
    return out


@pytest.mark.parametrize("path", [("dec_layers", "xattn", "wo"),
                                  ("enc_layers", "attn", "wq")])
def test_params_from_numpy_rejects_what_does_not_fit(path):
    cfg_j, cfg_t, params, _ = _cached_pair("whisper")
    tree = jax.tree_util.tree_map(np.asarray, params)
    leaf = tree
    for k in path:
        leaf = leaf[k]
    stray = _with(tree, path[:-1] + ("stray",), np.zeros_like(leaf))
    with pytest.raises(ValueError, match=r"no parameter takes: \[.*stray"):
        params_from_numpy(cfg_t, stray, "cpu")
    longer = _with(tree, path, np.concatenate([leaf, leaf[:1]]))
    with pytest.raises(ValueError, match="does not stack"):
        params_from_numpy(cfg_t, longer, "cpu")
    narrower = _with(tree, path, leaf[..., :-1])
    with pytest.raises(ValueError, match="does not fit"):
        params_from_numpy(cfg_t, narrower, "cpu")
    with pytest.raises(ValueError, match="enc_pos: .* does not fit"):
        params_from_numpy(dataclasses.replace(cfg_t, n_audio_frames=16),
                          tree, "cpu")


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D", [
    (2, 4, 4, 1, 37, 64),          # one query row, as a decode step
    (2, 4, 2, 5, 130, 32),         # GQA, a key tail past two tiles
    (1, 2, 2, 3, 300, 64),
])
def test_flash_attention_ref_cross_matches_pallas(B, H, Hkv, S, Sk, D):
    """Non-causal attention with Sq != Sk and no offset (whisper's
    cross-attention): the port's plain version against the Pallas kernel
    in interpret mode, atol 2e-3 / rtol 1e-3 as in
    ``tests/test_torch_kernels.py``."""
    rng = np.random.default_rng(S * 11 + Sk)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False,
                                impl="pallas", block_q=32, block_k=32)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=False)
    assert got.shape == (B, H, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-2b"])
def test_bf16_forward_matches_jax(arch):
    """bf16 at the reduced depth (2 layers, and whisper's 2 encoder
    layers): both sides round activations to bf16 at other places."""
    cfg_j, cfg_t, params, model = _pair(arch, {})
    assert model.embed.dtype == torch.bfloat16
    prompts, extra = _inputs(cfg_j, 7, S=16)
    want = jlm.forward(cfg_j, params, _jbatch(prompts, extra))
    got = tlm.forward(cfg_t, model, {"tokens": prompts, **extra})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_serving_runs_the_encoder_without_a_graph():
    """``encode_audio`` and ``cross_kv`` are differentiable (the training
    forward reaches the encoder through them); serving's ``decode_aux``
    runs them under no_grad, so even a model whose parameters require
    grad serves with no graph."""
    cfg = tget_arch("whisper-tiny").reduced(dtype="float32")
    model = tlm.init_params(cfg, 0, "cpu").requires_grad_(True)
    _, extra = draw_inputs(cfg, np.random.default_rng(0), 2, 4)
    aux, _ = decode_aux(cfg, model, extra)
    assert aux["enc_states"].grad_fn is None
    assert all(aux["cross_kv"][k].grad_fn is None for k in ("k", "v"))
    enc = tlm.encode_audio(cfg, model, extra["audio_embed"])
    assert enc.grad_fn is not None
    assert tlm.cross_kv(cfg, model, enc)["k"].grad_fn is not None
