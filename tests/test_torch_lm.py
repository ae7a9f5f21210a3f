"""The port's serving slice on the CPU against ``repro.models.lm``.

Weights come from the JAX ``init_params`` and are carried across with
``params_from_numpy``; token ids come from numpy with a fixed seed.
Tolerances: float32 atol/rtol 2e-4 (the two sides sum matrix products
and the streamed softmax in different orders); bfloat16 atol/rtol 5e-2
(both round every layer's activations to bf16, at different places).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models.registry import get_arch as jget_arch
from repro_torch.launch.serve import generate
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.registry import get_arch as tget_arch

F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)

# minitron-4b reduced as the JAX tests reduce it, and a padded variant:
# at full width minitron pads its 24 query heads to 32 (tp_pad=16).
VARIANTS = {
    "minitron": ("minitron-4b", dict(dtype="float32")),
    "minitron-padded": ("minitron-4b", dict(n_heads=3, n_kv_heads=1,
                                            d_head=32, tp_pad=4,
                                            dtype="float32")),
}


def _pair(arch, overrides, seed=0):
    cfg_j = jget_arch(arch).reduced(**overrides)
    cfg_t = tget_arch(arch).reduced(**overrides)
    params = jlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg_j, cfg_t, params, params_from_numpy(cfg_t, tree, "cpu")


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return _pair(*VARIANTS[request.param])


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def test_config_is_a_copy():
    j, t = jget_arch("minitron-4b"), tget_arch("minitron-4b")
    assert j.__dict__ == t.__dict__
    assert (t.n_layers, t.d_model, t.padded_heads, t.head_dim) == \
        (32, 3072, 32, 128)
    assert t.n_params() == j.n_params()
    assert t.reduced().__dict__ == j.reduced().__dict__


def test_forward_matches_jax(pair):
    cfg_j, cfg_t, params, model = pair
    tokens = np.random.default_rng(1).integers(
        0, cfg_j.vocab, size=(2, 13)).astype(np.int32)
    want = jlm.forward(cfg_j, params, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward(cfg_t, model, {"tokens": tokens})
    assert got.shape == (2, 13, cfg_t.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        _np(tlm.prefill(cfg_t, model, {"tokens": tokens})),
        _np(want)[:, -1], **F32_TOL)


def test_decode_steps_match_jax(pair):
    cfg_j, cfg_t, params, model = pair
    B, steps, max_len = 2, 6, 9
    tokens = np.random.default_rng(2).integers(
        0, cfg_j.vocab, size=(B, steps)).astype(np.int32)
    step = jax.jit(partial(jlm.decode_step, cfg_j))
    cj = jlm.init_cache(cfg_j, B, max_len)
    ct = tlm.init_cache(cfg_t, B, max_len, device="cpu")
    for t in range(steps):
        lj, cj = step(params, cj, jnp.asarray(tokens[:, t]), jnp.int32(t))
        lt, ct = tlm.decode_step(cfg_t, model, ct, tokens[:, t], t)
        np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
    for name in ("k", "v"):
        assert ct["kv"][name].shape == cj["kv"][name].shape
        np.testing.assert_allclose(_np(ct["kv"][name]), _np(cj["kv"][name]),
                                   **F32_TOL)


def test_decode_replay_matches_forward(pair):
    """The decode replay at position P-1 equals the full-sequence forward
    at its last position: the two kernels agree with each other."""
    _, cfg_t, _, model = pair
    prompts = np.random.default_rng(3).integers(
        0, cfg_t.vocab, size=(2, 10)).astype(np.int32)
    res = generate(cfg_t, model, prompts, gen=1)
    np.testing.assert_allclose(
        _np(res.prompt_logits),
        _np(tlm.prefill(cfg_t, model, {"tokens": prompts})), **F32_TOL)


def _jax_greedy(cfg, params, prompts, gen):
    """The loop of repro/launch/serve.py:65-80; returns the tokens and the
    logits that chose each of them."""
    B, P = prompts.shape
    step = jax.jit(partial(jlm.decode_step, cfg))
    cache = jlm.init_cache(cfg, B, P + gen)
    for t in range(P):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, t]),
                             jnp.int32(t))
    out, chooser = [], []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(P, P + gen):
        out.append(np.asarray(tok))
        chooser.append(np.asarray(logits, np.float32))
        logits, cache = step(params, cache, tok, jnp.int32(t))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return np.stack(out, axis=1), chooser


def test_generate_matches_jax_greedy(pair):
    cfg_j, cfg_t, params, model = pair
    prompts = np.random.default_rng(0).integers(
        0, cfg_j.vocab, size=(2, 6)).astype(np.int32)
    want, chooser = _jax_greedy(cfg_j, params, prompts, gen=8)
    res = generate(cfg_t, model, prompts, gen=8)
    assert res.tokens.shape == (2, 8) and res.logits_finite
    # Compare tokens up to the first step whose top two logits lie within
    # 1e-4 (a near tie either side may break differently); the logits
    # that chose the first token are compared in any case.
    n = 8
    for i, lg in enumerate(chooser):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if np.any(top2[:, 1] - top2[:, 0] < 1e-4):
            n = i
            break
    np.testing.assert_array_equal(res.tokens[:, :n], want[:, :n])
    np.testing.assert_allclose(_np(res.prompt_logits), chooser[0],
                               **F32_TOL)


def test_bf16_forward_matches_jax():
    cfg_j, cfg_t, params, model = _pair("minitron-4b", {})
    assert model.embed.dtype == torch.bfloat16
    tokens = np.random.default_rng(4).integers(
        0, cfg_j.vocab, size=(2, 12)).astype(np.int32)
    want = jlm.forward(cfg_j, params, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward(cfg_t, model, {"tokens": tokens})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_granite_mqa_gelu_forward_matches_jax():
    """Another dense config of the zoo: one kv head, tanh-gelu MLP."""
    cfg_j, cfg_t, params, model = _pair("granite-20b",
                                        dict(dtype="float32"))
    tokens = np.random.default_rng(5).integers(
        0, cfg_j.vocab, size=(2, 9)).astype(np.int32)
    want = jlm.forward(cfg_j, params, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward(cfg_t, model, {"tokens": tokens})
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_params_from_numpy_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.random.default_rng(6).normal(size=(3, 5)),
                               jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


def test_params_from_numpy_rejects_wrong_shapes():
    cfg_j, cfg_t, params, _ = _pair("minitron-4b", dict(dtype="float32"))
    tree = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="mlp.w_in: .* does not fit"):
        params_from_numpy(cfg_t.reduced(d_ff=64, dtype="float32"), tree,
                          "cpu")


def test_profile_decode_runs_and_measures_no_device_on_cpu():
    from repro_torch.launch.profile_serve import profile_decode
    cfg = tget_arch("minitron-4b").reduced()
    model = tlm.init_params(cfg, 0, device="cpu")
    out = profile_decode(cfg, model, batch=2, prompt_len=3, steps=2)
    assert out["device"] == "cpu" and out["wall_ms_per_step"] > 0
    assert out["idle_share"] == "not measured"


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "gemma3-27b",
                                  "granite-moe-1b-a400m", "whisper-tiny",
                                  "qwen2-vl-2b"])
def test_other_families_raise_with_roadmap_item(arch):
    """whisper-tiny and qwen2-vl-2b still raise, naming their ROADMAP.md
    item; the families ported since (gemma3, MoE, MLA) build."""
    cfg = tget_arch(arch).reduced()
    if arch in ("whisper-tiny", "qwen2-vl-2b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tlm.init_params(cfg, 0, device="cpu")
    else:
        tlm.check_supported(cfg)
        model = tlm.init_params(cfg, 0, device="cpu")
        assert all(torch.isfinite(p).all() for p in model.parameters())
