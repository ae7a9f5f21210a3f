"""The port's optimizer pieces (``repro_torch.optim``, ``runtime/overlap``)
against the JAX package's on the CPU, on inputs made with numpy from a
seed.  Tolerance 1e-6 relative (both compute in float32, in other
orders); the int8 values of ``compress_grads`` are compared for
equality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models.registry import get_arch as jget_arch
from repro.optim import compression as jcomp
from repro.runtime import overlap as joverlap
from repro_torch import optim as toptim
from repro_torch.models.convert import (params_from_numpy, reference_groups,
                                        reference_leaves,
                                        split_reference_tree,
                                        stack_reference_tree)
from repro_torch.models.registry import get_arch
from repro_torch.optim import compression as tcomp
from repro_torch.runtime import overlap as toverlap

RTOL = 1e-6


def _tree(rng, dtype=np.float32, scale=1.0):
    return {"a": (rng.normal(size=(7, 5)) * scale).astype(dtype),
            "b": {"c": (rng.normal(size=(11,)) * scale).astype(dtype),
                  "d": (rng.normal(size=(3, 4, 2)) * scale).astype(dtype)}}


def _flat(tree):
    return [torch.from_numpy(np.asarray(x, np.float32).copy())
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10000, 12000])
@pytest.mark.parametrize("warmup,total", [(100, 10000), (0, 1), (10, 40)])
def test_schedules_match_reference(step, warmup, total):
    want = float(joptim.warmup_cosine(step, warmup, total))
    got = float(toptim.warmup_cosine(step, warmup, total))
    assert abs(got - want) <= RTOL * max(abs(want), 1e-30)
    got_t = float(toptim.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                       warmup, total))
    assert got_t == got
    assert float(toptim.constant(step, 0.5)) == float(
        joptim.constant(step, 0.5)) == 0.5


@pytest.mark.parametrize("scale", [1e-3, 1.0, 10.0])     # clip on / off
def test_global_norm_matches_reference(scale):
    tree = _tree(np.random.default_rng(0), scale=scale)
    want = float(joptim.global_norm(tree))
    got = float(toptim.global_norm(_flat(tree)))
    assert abs(got - want) <= RTOL * want


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gscale,lr_scale", [(1e-2, 1.0), (3.0, 0.25)])
def test_apply_updates_matches_reference(moment_dtype, gscale, lr_scale):
    """Three AdamW steps on float32 parameters from the same numpy trees,
    the gradient norm below and above the clip; bf16 moments round as the
    reference's."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    cfg_j = joptim.AdamWConfig(moment_dtype=moment_dtype)
    cfg_t = toptim.AdamWConfig(moment_dtype=moment_dtype)
    jp, js = params, joptim.init_state(cfg_j, params)
    tp = _flat(params)
    ts = toptim.init_state(cfg_t, tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for _ in range(3):
        grads = _tree(rng, scale=gscale)
        jp, js = joptim.apply_updates(cfg_j, jp, grads, js, lr_scale)
        _, ts = toptim.apply_updates(cfg_t, tp, _flat(grads), ts, lr_scale)
    assert int(ts.step) == int(js.step) == 3
    for got, want in zip(tp, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-7)
    # a moment that cancels to near zero is held to the leaf's scale
    for got, want in zip(ts.m + ts.v, jax.tree_util.tree_leaves(js.m)
                         + jax.tree_util.tree_leaves(js.v)):
        assert str(got.dtype).endswith(moment_dtype)
        want = np.asarray(want, np.float32)
        tol = 1e-2 if moment_dtype == "bfloat16" else RTOL
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def test_apply_updates_bf16_params_match_reference():
    """bf16 parameters: the update in float32, rounded back to bf16 as the
    reference rounds it (equal, or one bf16 step apart at a tie)."""
    rng = np.random.default_rng(2)
    import ml_dtypes
    params = jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16),
                                    _tree(rng))
    grads = _tree(rng)
    cfg = joptim.AdamWConfig()
    jp, _ = joptim.apply_updates(cfg, params, grads,
                                 joptim.init_state(cfg, params), 1.0)
    tp = [torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16) for a in jax.tree_util.tree_leaves(params)]
    toptim.apply_updates(toptim.AdamWConfig(), tp, _flat(grads),
                         toptim.init_state(toptim.AdamWConfig(), tp), 1.0)
    for got, want in zip(tp, jax.tree_util.tree_leaves(jp)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2 ** -7, atol=0)


def _reduced_grads():
    """Gradients of the reduced minitron-4b's loss (the reference's) and
    the port's model holding the same weights."""
    jcfg = jget_arch("minitron-4b").reduced(dtype="float32")
    tcfg = get_arch("minitron-4b").reduced(dtype="float32")
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    b = jpipe.batch_for_step(jpipe.DataConfig(jcfg.vocab, 16, 2), 0)
    grads = jax.grad(lambda p: jlm.loss_fn(jcfg, p, b))(params)
    model = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    return tcfg, model, jax.tree_util.tree_map(np.asarray, grads)


def test_compress_grads_takes_one_scale_per_reference_leaf():
    """compress_grads on a reduced model's gradients and a random error
    feedback: the int8 values equal the reference's ``compress_leaf`` of
    each stacked leaf (one scale over all its layers), and the synced
    gradients and the new error feedback within 1e-6."""
    tcfg, model, grads = _reduced_grads()
    rng = np.random.default_rng(3)
    err = jax.tree_util.tree_map(
        lambda g: (rng.normal(size=g.shape) * np.abs(g).max() * 0.1
                   ).astype(np.float32), grads)
    tg = split_reference_tree(tcfg, model, grads, "cpu")
    te = split_reference_tree(tcfg, model, err, "cpu")
    groups = reference_groups(tcfg, model)
    assert sorted(i for g in groups for i in g) == list(range(len(tg)))
    stacked = [len(g) for g in groups if len(g) > 1]
    assert stacked and all(n == tcfg.n_layers for n in stacked)
    for (path, lead, _), idx in zip(reference_leaves(tcfg, model), groups):
        g = grads
        e = err
        for key in path:
            g, e = g[key], e[key]
        want_q, _, _ = jcomp.compress_leaf(jnp.asarray(g) + jnp.asarray(e))
        qs, _, _ = tcomp.compress_group([tg[i] + te[i] for i in idx])
        got_q = torch.stack(qs).reshape(np.asarray(want_q).shape)
        assert np.array_equal(got_q.numpy(), np.asarray(want_q)), path
    jg, je = joptim.compress_grads(grads, err)
    got_g, got_e = toptim.compress_grads(tg, te, groups)
    for got, want in ((got_g, jg), (got_e, je)):
        got = stack_reference_tree(tcfg, model, got)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=str(path))
    # one scale per layer would change the int8 values of a stacked leaf
    idx = next(g for g in groups if len(g) > 1)
    per_layer = [tcomp.compress_leaf(tg[i] + te[i])[0] for i in idx]
    grouped = tcomp.compress_group([tg[i] + te[i] for i in idx])[0]
    assert any(not torch.equal(a, b) for a, b in zip(per_layer, grouped))


def test_compress_leaf_roundtrip():
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(64,)).astype(np.float32))
    q, scale, resid = tcomp.compress_leaf(g)
    jq, jscale, jresid = jcomp.compress_leaf(jnp.asarray(g.numpy()))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    torch.testing.assert_close(tcomp.decompress_leaf(q, scale) + resid, g,
                               atol=1e-6, rtol=0)
    assert [e.dtype for e in toptim.init_error([g])] == [torch.float32]


def test_accumulate_grads_matches_reference():
    """Mean loss and grads over 2 microbatches of a quadratic loss, and
    the microbatch split."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    batch = {"x": rng.normal(size=(4, 6)).astype(np.float32),
             "y": rng.normal(size=(4, 3)).astype(np.float32)}

    def jloss(p, b):
        return jnp.mean((b["x"] @ p - b["y"]) ** 2)

    for n in (1, 2):
        jl, jg = joverlap.accumulate_grads(jloss, jnp.asarray(w), batch, n)
        tw = torch.from_numpy(w.copy()).requires_grad_(True)
        tl, (tg,) = toverlap.accumulate_grads(
            lambda b: torch.mean((torch.as_tensor(b["x"]) @ tw
                                  - torch.as_tensor(b["y"])) ** 2),
            [tw], batch, n)
        assert abs(float(tl) - float(jl)) <= RTOL * abs(float(jl))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=1e-7)
    mb = toverlap.split_microbatches(batch, 2)
    assert mb["x"].shape == (2, 2, 6) and np.array_equal(mb["x"][1],
                                                         batch["x"][2:])
