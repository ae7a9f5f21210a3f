"""The rest of the decoder-only zoo on the CPU against ``repro.models.lm``:
gemma3-27b (grouped local/global layers, ring-buffer decode),
deepseek-v3-671b (MLA, a dense layer then an MoE layer with a shared
expert) and granite-moe-1b-a400m (MoE), each reduced as the JAX tests
reduce it.

Weights come from the JAX ``init_params`` and are carried across with
``params_from_numpy``; token ids come from numpy with a fixed seed.
Tolerances, as ``tests/test_torch_lm.py`` states them: float32 atol/rtol
2e-4, bfloat16 atol/rtol 5e-2.
"""
import dataclasses
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
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch as tget_arch

F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)

# gemma3 at reduced()'s one group of 2 local + 1 global layers (window 16)
# and with a 2-layer local tail; the prompts below are longer than the
# window, so the local layers' rings wrap.
VARIANTS = {
    "gemma3-3": ("gemma3-27b", dict(dtype="float32")),
    "gemma3-5": ("gemma3-27b", dict(n_layers=5, dtype="float32")),
    "deepseek-v3": ("deepseek-v3-671b", dict(dtype="float32")),
    "granite-moe": ("granite-moe-1b-a400m", dict(dtype="float32")),
}
PROMPT = 24


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


def _no_drops(cfg):
    """The config with capacity_factor E / k: every expert can take every
    token (cap >= T), so no assignment is dropped."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)


def _tokens(cfg, seed, B=2, S=PROMPT):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _flat(cache):
    """(name, array) of every leaf of a cache dict, in sorted order."""
    out = []
    for key in sorted(cache):
        sub = cache[key]
        if isinstance(sub, dict):
            out += [(f"{key}.{n}", a) for n, a in _flat(sub)]
        else:
            out.append((key, sub))
    return out


def test_configs_are_copies():
    for arch in {a for a, _ in VARIANTS.values()}:
        j, t = jget_arch(arch), tget_arch(arch)
        assert j.__dict__ == t.__dict__
        assert t.reduced().__dict__ == j.reduced().__dict__


def test_forward_matches_jax(pair):
    cfg_j, cfg_t, params, model = pair
    tokens = _tokens(cfg_j, 1)
    want = jlm.forward(cfg_j, params, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward(cfg_t, model, {"tokens": tokens})
    assert got.shape == (2, PROMPT, cfg_t.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_decode_steps_match_jax(pair):
    """Logits and every cache after each decode step, past the point where
    a local layer's ring wraps."""
    cfg_j, cfg_t, params, model = pair
    B, steps = 2, PROMPT
    if cfg_t.local_global_ratio:
        assert steps > cfg_t.sliding_window
    tokens = _tokens(cfg_j, 2, B, steps)
    step = jax.jit(partial(jlm.decode_step, cfg_j))
    cj = jlm.init_cache(cfg_j, B, steps + 2)
    ct = tlm.init_cache(cfg_t, B, steps + 2, device="cpu")
    for t in range(steps):
        lj, cj = step(params, cj, jnp.asarray(tokens[:, t]), jnp.int32(t))
        lt, ct = tlm.decode_step(cfg_t, model, ct, tokens[:, t], t)
        np.testing.assert_allclose(_np(lt), _np(lj), **F32_TOL)
        got, want = _flat(ct), _flat(cj)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, a), (_, b) in zip(got, want):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(_np(a), _np(b), **F32_TOL,
                                       err_msg=f"{name} at step {t}")


def test_decode_replay_matches_forward(pair):
    """The decode replay at position P-1 equals the full-sequence forward
    at its last position; MoE configs at a capacity that drops nothing,
    since prefill and decode steps see other token counts and so other
    capacities."""
    _, cfg_t, _, model = pair
    cfg = _no_drops(cfg_t)
    prompts = _tokens(cfg, 3)
    res = generate(cfg, model, prompts, gen=1)
    np.testing.assert_allclose(
        _np(res.prompt_logits),
        _np(tlm.prefill(cfg, model, {"tokens": prompts})), **F32_TOL)


def test_generate_matches_jax_greedy(pair):
    """Greedy tokens of the port's serving loop equal the JAX decode
    loop's (repro/launch/serve.py:65-80), up to the first near tie."""
    cfg_j, cfg_t, params, model = pair
    B, P, gen = 2, 18, 8
    prompts = _tokens(cfg_j, 0, B, P)
    step = jax.jit(partial(jlm.decode_step, cfg_j))
    cache = jlm.init_cache(cfg_j, B, P + gen)
    for t in range(P):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, t]),
                             jnp.int32(t))
    want, chooser = [], []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(P, P + gen):
        want.append(np.asarray(tok))
        chooser.append(np.asarray(logits, np.float32))
        logits, cache = step(params, cache, tok, jnp.int32(t))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    res = generate(cfg_t, model, prompts, gen=gen)
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


def test_params_from_numpy_carries_every_leaf(pair):
    """Each parameter equals its leaf of the JAX tree, and every leaf is
    taken: deepseek-v3's `mtp` block too, which builds the model's MTP
    block."""
    cfg_j, cfg_t, params, model = pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    n_params = 0
    for name, p in model.named_parameters():
        n_params += 1
        assert torch.isfinite(p).all(), name
    stacked = sum(int(np.prod(a.shape[:_lead(path)]))
                  for path, a in _leaf_paths(tree))
    assert n_params == stacked
    assert ("mtp" in tree) == bool(cfg_t.mtp) == (model.mtp is not None)
    if cfg_t.mtp:
        np.testing.assert_array_equal(model.mtp.proj.numpy(),
                                      tree["mtp"]["proj"])
        np.testing.assert_array_equal(model.mtp.layer.attn.w_uq.numpy(),
                                      tree["mtp"]["layer"]["attn"]["w_uq"])
    if cfg_t.local_global_ratio:
        g = model.groups[0]
        np.testing.assert_array_equal(
            g.local[1].attn.wq.numpy(),
            tree["groups"]["local"]["attn"]["wq"][0, 1])
        np.testing.assert_array_equal(
            g.global_.mlp.w_gate.numpy(),
            tree["groups"]["global"]["mlp"]["w_gate"][0])
    if cfg_t.n_experts:
        moe = model.layers[-1].moe
        np.testing.assert_array_equal(
            moe.experts.w_out.numpy(),
            tree["layers"]["moe"]["experts"]["w_out"][-1])
        np.testing.assert_array_equal(moe.router.numpy(),
                                      tree["layers"]["moe"]["router"][-1])
    if cfg_t.mla:
        np.testing.assert_array_equal(
            model.dense_layers[0].attn.w_uk.numpy(),
            tree["dense_layers"]["attn"]["w_uk"][0])


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _lead(path):
    """The stacked axes before a leaf of the JAX tree: (G, R) for gemma3's
    locals, (n,) for other stacks, none for top-level leaves."""
    if path[:2] == ("groups", "local"):
        return 2
    if path[0] in ("layers", "dense_layers", "tail", "groups"):
        return 1
    return 0


def _with(tree, path, value):
    """A copy of `tree` with the leaf at `path` set to `value`."""
    out = dict(tree)
    sub = out
    for k in path[:-1]:
        sub[k] = dict(sub[k])
        sub = sub[k]
    sub[path[-1]] = value
    return out


@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-v3-671b",
                                  "granite-moe-1b-a400m"])
def test_params_from_numpy_rejects_what_does_not_fit(arch):
    cfg_j, cfg_t, params, _ = _pair(arch, dict(dtype="float32"))
    tree = jax.tree_util.tree_map(np.asarray, params)
    attn = (("groups", "global", "attn") if cfg_t.local_global_ratio
            else ("layers", "attn"))
    wo = tree
    for k in attn + ("wo",):
        wo = wo[k]
    stray = _with(tree, attn + ("stray",), np.zeros_like(wo))
    with pytest.raises(ValueError, match=r"no parameter takes: \[.*stray"):
        params_from_numpy(cfg_t, stray, "cpu")
    longer = _with(tree, attn + ("wo",), np.concatenate([wo, wo[:1]]))
    with pytest.raises(ValueError, match="does not stack"):
        params_from_numpy(cfg_t, longer, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        params_from_numpy(dataclasses.replace(cfg_t, d_model=64), tree,
                          "cpu")


@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-v3-671b",
                                  "granite-moe-1b-a400m"])
def test_bf16_forward_matches_jax(arch):
    cfg_j, cfg_t, params, model = _pair(arch, {})
    assert model.embed.dtype == torch.bfloat16
    tokens = _tokens(cfg_j, 4, S=20)
    want = jlm.forward(cfg_j, params, {"tokens": jnp.asarray(tokens)})
    got = tlm.forward(cfg_t, model, {"tokens": tokens})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("family", ["diffusion", "retrieval"])
def test_unknown_family_raises(family):
    """check_supported still refuses a family the port does not know,
    before any weight is allocated."""
    cfg = dataclasses.replace(tget_arch("minitron-4b").reduced(),
                              family=family)
    with pytest.raises(NotImplementedError, match=f"family '{family}'"):
        tlm.check_supported(cfg)
    with pytest.raises(NotImplementedError, match=f"family '{family}'"):
        tlm.init_params(cfg, 0, device="cpu")
