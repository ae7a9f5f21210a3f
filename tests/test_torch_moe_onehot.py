"""The port's one-hot MoE dispatch (``moe_dispatch="onehot"``) on the CPU
against ``repro.models.moe._dispatch_onehot`` and against the port's own
sort dispatch.

Weights come from the JAX ``init_params`` of the reduced configs
(granite-moe-1b-a400m: 8 experts top 2; deepseek-v3-671b: the same with
one shared expert), carried across with ``params_from_numpy``; inputs
from numpy with a fixed seed, in float32, at capacity factors that keep
every assignment (E / k) and that drop many (0.25).  Tolerance: 2e-4
absolute and relative (the einsums sum in other orders); the kept
masks and the counted drops must be equal.  moe_a2a with the one-hot
dispatch on a model axis is held in ``tests/test_torch_model_axis.py``.
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

TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
FACTORS = (0.25, 1.25, 4.0)
T_SHAPE = (2, 12)          # B, S: T = 24 tokens


def _pair(arch, **overrides):
    """The first MoE layer's weights on both sides, and the configs."""
    over = dict(dtype="float32", moe_dispatch="onehot", **overrides)
    cfg_j = jget_arch(arch).reduced(**over)
    cfg_t = tget_arch(arch).reduced(**over)
    params = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg_t, jax.tree_util.tree_map(np.asarray,
                                                            params), "cpu")
    p_j = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["moe"])
    return cfg_j, cfg_t, p_j, model.layers[0].moe


def _x(cfg, seed=0):
    return np.random.default_rng(seed).normal(
        size=T_SHAPE + (cfg.d_model,)).astype(np.float32)


def _routed(cfg_j, p_j, x):
    x2d = x.reshape(-1, cfg_j.d_model)
    gates, idx = jmoe._router_probs(p_j, jnp.asarray(x2d), cfg_j)
    return x2d, gates, idx


def _torch(a, long=False):
    t = torch.from_numpy(np.array(a))
    return t.long() if long else t


@pytest.mark.parametrize("capacity_factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_onehot_dispatch_matches_the_reference(arch, capacity_factor):
    """The expert buffers, the combine of random expert outputs and the
    kept mask of ``_dispatch_onehot`` against the reference's: buffers
    and combine within 2e-4, the kept mask the one the reference's
    combine reveals (fed ones and one choice's gates at a time)."""
    cfg_j, cfg_t, p_j, _ = _pair(arch, capacity_factor=capacity_factor)
    x2d, gates, idx = _routed(cfg_j, p_j, _x(cfg_j))
    T, k = idx.shape
    E = cfg_j.n_experts
    cap = tmoe.capacity(cfg_t, T)
    xe_j, comb_j = jmoe._dispatch_onehot(jnp.asarray(x2d), gates, idx, E,
                                         cap, jnp.float32)
    xe_t, comb_t, keep_t = tmoe._dispatch_onehot(
        _torch(x2d), _torch(gates), _torch(idx, long=True), E, cap)
    assert xe_t.shape == (E, cap, cfg_t.d_model)
    np.testing.assert_allclose(xe_t.numpy(), np.asarray(xe_j), **TOL)
    ye = np.random.default_rng(2).normal(
        size=(E, cap, cfg_j.d_model)).astype(np.float32)
    got = comb_t(torch.from_numpy(ye))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(comb_j(jnp.asarray(ye))), **TOL)
    ones = jnp.ones((E, cap, 1), jnp.float32)
    keep_j = []
    for j in range(k):
        g = jnp.zeros_like(gates).at[:, j].set(1.0)
        _, cj = jmoe._dispatch_onehot(jnp.asarray(x2d), g, idx, E, cap,
                                      jnp.float32)
        keep_j.append(np.asarray(cj(ones))[:, 0] > 0.5)
    np.testing.assert_array_equal(keep_t.numpy(), np.stack(keep_j, axis=1))
    if capacity_factor < 1:
        assert not keep_t.all()
    elif capacity_factor >= E / k:
        assert keep_t.all()


@pytest.mark.parametrize("capacity_factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_onehot_and_sort_keep_the_same_assignments(arch, capacity_factor):
    """The one-hot and the sort dispatch of the port on the same routing:
    the same kept mask (token-major within each expert, the overflow
    column cut), the same expert buffers (each row a copy of one token or
    zero: bit-equal) and combines within 2e-4."""
    cfg_j, cfg_t, p_j, _ = _pair(arch, capacity_factor=capacity_factor)
    x2d, gates, idx = _routed(cfg_j, p_j, _x(cfg_j, seed=3))
    E = cfg_j.n_experts
    cap = tmoe.capacity(cfg_t, idx.shape[0])
    args = (_torch(x2d), _torch(gates), _torch(idx, long=True), E, cap)
    xe_o, comb_o, keep_o = tmoe._dispatch_onehot(*args)
    xe_s, comb_s, keep_s = tmoe._dispatch_sort(*args)
    assert torch.equal(keep_o, keep_s)
    assert torch.equal(xe_o, xe_s)
    ye = torch.from_numpy(np.random.default_rng(4).normal(
        size=(E, cap, cfg_j.d_model)).astype(np.float32))
    np.testing.assert_allclose(comb_o(ye).numpy(), comb_s(ye).numpy(),
                               **TOL)


@pytest.mark.parametrize("capacity_factor", FACTORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_onehot_matches_the_reference_and_the_sort(
        arch, capacity_factor):
    """``moe_dense`` with the one-hot dispatch against the reference's
    one-hot ``moe_dense`` (within 2e-4) and against the port's sort
    dispatch on the same weights: outputs within 2e-4, ``dropped``
    equal, and counted once a forward."""
    cfg_j, cfg_t, p_j, p_t = _pair(arch, capacity_factor=capacity_factor)
    x = _x(cfg_t, seed=5)
    want = np.asarray(jmoe.moe_dense(p_j, jnp.asarray(x), cfg_j))
    p_t.dropped.zero_()
    got = tmoe.moe_dense(p_t, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dropped = int(p_t.dropped)
    p_t.dropped.zero_()
    sort = tmoe.moe_dense(p_t, torch.from_numpy(x),
                          dataclasses.replace(cfg_t, moe_dispatch="sort"))
    np.testing.assert_allclose(got.numpy(), sort.numpy(), **TOL)
    assert int(p_t.dropped) == dropped
    if capacity_factor < 1:
        assert dropped > 0
    elif capacity_factor >= cfg_t.n_experts / cfg_t.top_k:
        assert dropped == 0


def test_onehot_moe_gradients_match_the_sort():
    """Under grad, ``moe_dense`` with the one-hot dispatch gives the sort
    dispatch's gradients of the input, the router and the experts within
    2e-4 (the router's through the kept gates), and inside
    ``layers.recomputing()`` it counts no drop."""
    from repro_torch.models.layers import recomputing
    _, cfg_t, _, p_t = _pair("granite-moe-1b-a400m", capacity_factor=0.25)
    grads = {}
    for how in ("onehot", "sort"):
        cfg = dataclasses.replace(cfg_t, moe_dispatch=how)
        x = torch.from_numpy(_x(cfg, seed=6)).requires_grad_(True)
        ws = [p_t.router, p_t.experts.w_in, p_t.experts.w_gate,
              p_t.experts.w_out]
        for w in ws:
            w.requires_grad_(True)
            w.grad = None
        y = tmoe.moe_dense(p_t, x, cfg)
        (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
        grads[how] = [x.grad] + [w.grad for w in ws]
    for a, b in zip(grads["onehot"], grads["sort"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    p_t.dropped.zero_()
    with torch.no_grad(), recomputing():
        tmoe.moe_dense(p_t, torch.from_numpy(_x(cfg_t)), cfg_t)
    assert int(p_t.dropped) == 0
