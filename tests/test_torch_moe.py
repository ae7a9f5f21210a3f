"""The port's MoE feed-forward on the CPU against ``repro.models.moe``.

Weights come from the JAX ``init_params`` of the reduced configs
(granite-moe-1b-a400m: 8 experts top 2; deepseek-v3-671b: the same with
one shared expert) and are carried across with ``params_from_numpy``;
inputs come from numpy with a fixed seed.  Tolerances: float32
atol/rtol 2e-4 (the expert products and the combine sum in other
orders); the router's choices, the kept / dropped assignments and the
dispatched expert buffers must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.registry import get_arch as jget_arch
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch as tget_arch

F32_TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
T_SHAPE = (2, 12)          # B, S: T = 24 tokens


def _moe_pair(arch, **overrides):
    """The first MoE layer's weights on both sides, and the configs."""
    over = dict(dtype="float32", **overrides)
    cfg_j = jget_arch(arch).reduced(**over)
    cfg_t = tget_arch(arch).reduced(**over)
    params = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_numpy(cfg_t, tree, "cpu")
    p_j = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["moe"])
    return cfg_j, cfg_t, p_j, model.layers[0].moe


def _x(cfg, seed=0):
    return np.random.default_rng(seed).normal(
        size=T_SHAPE + (cfg.d_model,)).astype(np.float32)


def _jax_keep(x2d, gates, idx, E, cap):
    """The reference's kept mask (T, k): its combine, fed ones and the
    gates of one choice j at a time, returns keep[:, j]."""
    T, k = idx.shape
    ones = jnp.ones((E, cap, 1), jnp.float32)
    cols = []
    for j in range(k):
        g = jnp.zeros_like(gates).at[:, j].set(1.0)
        _, combine = jmoe._dispatch_sort(x2d, g, idx, E, cap, x2d.dtype)
        cols.append(np.asarray(combine(ones))[:, 0])
    return np.stack(cols, axis=1) > 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_match_jax(arch):
    cfg_j, cfg_t, p_j, p_t = _moe_pair(arch)
    x2d = _x(cfg_j).reshape(-1, cfg_j.d_model)
    gj, ij = jmoe._router_probs(p_j, jnp.asarray(x2d), cfg_j)
    gt, it = tmoe._router_probs(p_t, torch.from_numpy(x2d), cfg_t)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **F32_TOL)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_and_moe_dense_match_jax(arch, capacity_factor):
    """The sort dispatch at the default capacity factor and at one that
    drops assignments: the kept mask and the expert buffers equal the
    reference's, and moe_dense's output is within the float32 tolerance;
    the drops are counted in ``dropped``."""
    cfg_j, cfg_t, p_j, p_t = _moe_pair(arch, capacity_factor=capacity_factor)
    x = _x(cfg_j)
    x2d = x.reshape(-1, cfg_j.d_model)
    T = x2d.shape[0]
    E = cfg_j.n_experts
    cap = tmoe.capacity(cfg_t, T)
    assert cap == max(1, int(np.ceil(T * cfg_j.top_k / E * capacity_factor)))
    gates, idx = jmoe._router_probs(p_j, jnp.asarray(x2d), cfg_j)
    xe_j, _ = jmoe._dispatch_sort(jnp.asarray(x2d), gates, idx, E, cap,
                                  jnp.float32)
    xe_t, _, keep_t = tmoe._dispatch_sort(
        torch.from_numpy(x2d), torch.from_numpy(np.array(gates)),
        torch.from_numpy(np.array(idx)).long(), E, cap)
    keep_j = _jax_keep(jnp.asarray(x2d), gates, idx, E, cap)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    np.testing.assert_array_equal(xe_t.numpy(), np.asarray(xe_j))
    if capacity_factor < 1:
        assert not keep_j.all()          # the small factor drops some

    want = jmoe.moe_dense(p_j, jnp.asarray(x), cfg_j)
    p_t.dropped.zero_()
    got = tmoe.moe_dense(p_t, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert int(p_t.dropped) == int((~keep_j).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_takes_the_dense_path(arch):
    cfg_j, cfg_t, p_j, p_t = _moe_pair(arch)
    x = _x(cfg_j, seed=1)
    want = jmoe.moe(p_j, jnp.asarray(x), cfg_j)
    got = tmoe.moe(p_t, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_sort_combine_matches_jax_and_repeats(arch, capacity_factor):
    """The combine of the sort dispatch on random expert outputs: within
    the float32 tolerance of the reference's combine, and a second call
    gives the same bits (each token's k gated outputs are summed in a
    fixed order)."""
    cfg_j, cfg_t, p_j, p_t = _moe_pair(arch, capacity_factor=capacity_factor)
    x2d = _x(cfg_j).reshape(-1, cfg_j.d_model)
    E = cfg_j.n_experts
    cap = tmoe.capacity(cfg_t, x2d.shape[0])
    gates, idx = jmoe._router_probs(p_j, jnp.asarray(x2d), cfg_j)
    _, combine_j = jmoe._dispatch_sort(jnp.asarray(x2d), gates, idx, E, cap,
                                       jnp.float32)
    _, combine_t, _ = tmoe._dispatch_sort(
        torch.from_numpy(x2d), torch.from_numpy(np.array(gates)),
        torch.from_numpy(np.array(idx)).long(), E, cap)
    ye = np.random.default_rng(2).normal(
        size=(E, cap, cfg_j.d_model)).astype(np.float32)
    got = combine_t(torch.from_numpy(ye))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(combine_j(jnp.asarray(ye))),
                               **F32_TOL)
    assert torch.equal(got, combine_t(torch.from_numpy(ye)))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_refuses_the_onehot_dispatch(arch):
    """The one-hot dispatch, once refused, is ported: ``moe_dense`` with
    ``moe_dispatch="onehot"`` runs it, at a capacity that drops
    assignments, within the float32 tolerance of the reference's one-hot
    ``moe_dense``, and counts the same drops as the sort dispatch."""
    cfg_j, cfg_t, p_j, p_t = _moe_pair(arch, moe_dispatch="onehot",
                                       capacity_factor=0.25)
    x = _x(cfg_t)
    want = jmoe.moe_dense(p_j, jnp.asarray(x), cfg_j)
    p_t.dropped.zero_()
    got = tmoe.moe_dense(p_t, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    onehot_dropped = int(p_t.dropped)
    p_t.dropped.zero_()
    tmoe.moe_dense(p_t, torch.from_numpy(x),
                   dataclasses.replace(cfg_t, moe_dispatch="sort"))
    assert onehot_dropped == int(p_t.dropped) > 0
