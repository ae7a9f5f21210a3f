"""The port's float32 plan (``repro_torch.core.execplan.lower_float_steps``,
ROADMAP item 7) on the CPU against the JAX package's float32 plan.

The same graphs (the random graphs of ``tests/test_execplan.py`` and
mobilenet_v2 / resnet50_v1 at res_scale 0.25) and the same inputs, drawn
with numpy from a seed, go through both packages' plans; the port's runs
on ``device="cpu"``, where conv and fc take K1's plain version.  The
reference's float plan is bit-exact with its numpy interpreter; the
port's sums in another order, so it is held to the reference within the
one stated float tolerance, ``executor.float_plan_tol``: 1e-4 * max(1,
max|want|) per output.
"""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.core.execplan import lower_plan
from repro_torch.core.executor import FLOAT_SEMANTICS, float_plan_tol
from repro_torch.kernels import ops, ref

from test_execplan import random_graph
from test_torch_vision import _to_port

SEEDS = (0, 1, 2)
VISION = ("mobilenet_v2", "resnet50_v1")
# (plan asked for, requests): batches 1, 3, 8 and a ragged 5 in an 8-plan
BATCHES = ((1, 1), (3, 3), (8, 8), (8, 5))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: its CPU work is small,
    and the suite runs files side by side, some of them timing-sensitive
    (the reference's deadline and tracing-overhead tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_pair(seed):
    gj, bj = random_graph(seed)
    gt, wt = _to_port(gj, bj._weights)
    mj = japi.compile((gj, bj), cache=False)
    mt = tapi.compile(gt, weights=wt, cache=False, device="cpu")
    return mj, mt


def _vision_pair(name):
    mj = japi.compile(name, precision="float32", res_scale=0.25,
                      cache=False)
    mt = tapi.compile(name, precision="float32", res_scale=0.25,
                      cache=False, device="cpu")
    return mj, mt


@pytest.fixture(scope="module")
def pairs():
    """{key: (reference model, port model)}, float32, built on demand."""
    cache = {}

    def get(key):
        if key not in cache:
            cache[key] = _random_pair(key) if isinstance(key, int) \
                else _vision_pair(key)
        return cache[key]
    return get


def _images(g, n, seed=0):
    return np.random.default_rng(seed + 1000).normal(
        size=(n,) + g.inputs[0].shape).astype(np.float32)


def _within_tol(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.shape == w.shape and g.dtype == np.float32, (where, k)
        err = float(np.abs(g - w).max())
        assert err <= float_plan_tol(w), (where, k, err, float_plan_tol(w))


def _plans_agree(mj, mt, cap, n, seed):
    x = _images(mt.graph, n, seed=seed)
    inp = mt.graph.inputs[0].name
    pj, pt = mj.plan_for(cap), mt.plan_for(cap)
    assert pt.capacity == pj.capacity >= n      # the batch's bucket
    assert pt.granularity == "op"
    _within_tol(pt.run({inp: x}, n=n), pj.run({inp: x}, n=n),
                (mt.name, cap, n))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cap,n", BATCHES)
def test_float_plan_matches_reference_random_graphs(pairs, seed, cap, n):
    mj, mt = pairs(seed)
    _plans_agree(mj, mt, cap, n, seed)


@pytest.mark.parametrize("name", VISION)
@pytest.mark.parametrize("cap,n", BATCHES)
def test_float_plan_matches_reference_vision(pairs, name, cap, n):
    mj, mt = pairs(name)
    _plans_agree(mj, mt, cap, n, cap + n)


@pytest.mark.parametrize("key", SEEDS + VISION)
def test_verify_passes_on_float32_models(pairs, key):
    _, mt = pairs(key)
    rep = mt.verify(_images(mt.graph, 1, seed=4)[0])
    assert rep.ok


@pytest.mark.parametrize("key", (0,) + VISION)
def test_float_plan_runs_one_step_per_op_and_k1_per_conv_and_fc(pairs, key):
    """One step per op of the graph; the convs and fcs are K1's, counted
    by the labels the lowering gives them."""
    _, mt = pairs(key)
    plan = mt.plan_for(1)
    assert len(plan.steps) == len(mt.graph.ops)
    assert [st.label for st in plan.steps] == \
        [f"{op.name}@f32" for op in mt.graph.topo_ops()]
    assert plan.arena_bytes > 0


@pytest.mark.parametrize("key", (1, "mobilenet_v2"))
def test_port_float32_artifact_serves_in_reference(pairs, key, tmp_path):
    mj, mt = pairs(key)
    p = mt.save(str(tmp_path / "port_f32.rpa"))
    lj = japi.load(p, mmap=True)
    assert lj.precision == "float32"
    x = _images(mt.graph, 8, seed=11)
    inp = mt.graph.inputs[0].name
    _within_tol(mt.plan_for(8).run({inp: x}, n=8),
                lj.plan_for(8).run({inp: x}, n=8), "port -> reference")
    lt = tapi.load(p, mmap=True, device="cpu")
    _within_tol(lt.plan_for(8).run({inp: x}, n=8),
                lj.plan_for(8).run({inp: x}, n=8), "port -> port")
    info = lt.plan_cache_info()
    assert info["consts_computed"] == 0 and info["consts_served"] > 0


@pytest.mark.parametrize("key", (2, "resnet50_v1"))
def test_reference_float32_artifact_serves_in_port(pairs, key, tmp_path):
    """The reference's float32 artifact serves in the port within
    ``float_plan_tol``, but none of its plan constants is served: the two
    float32 lowerings key their constants differently (one step per op
    here, ``op@f32/wt``; steps split by rows there), so the port derives
    every constant of its own lowering again."""
    mj, mt = pairs(key)
    p = mj.save(str(tmp_path / "ref_f32.rpa"))
    lt = tapi.load(p, mmap=True, device="cpu")
    assert lt.precision == "float32"
    x = _images(lt.graph, 5, seed=12)
    inp = lt.graph.inputs[0].name
    _within_tol(lt.plan_for(8).run({inp: x}, n=5),
                mj.plan_for(8).run({inp: x}, n=5), "reference -> port")
    assert lt.verify(x[0]).ok
    mt.lower()
    own = mt.plan_cache_info()["consts_computed"]
    info = lt.plan_cache_info()
    assert own > 0
    assert (info["consts_computed"], info["consts_served"]) == (own, 0)


def test_causal_kinds_raise_naming_item_8():
    """ROADMAP item 8 is done: the causal kinds that raised naming it now
    lower, and each one-op graph's plan and compiled model agree with the
    reference's float32 plan within ``float_plan_tol``."""
    from repro.core.ir import GraphBuilder as JGraphBuilder
    from repro_torch.core.ir import GraphBuilder
    for kind in ("matmul", "layernorm", "softmax"):
        outs = []
        for builder in (GraphBuilder, JGraphBuilder):
            b = builder(f"causal_{kind}", seed=0)
            x = b.input((4, 1, 8))
            y = {"matmul": lambda: b.matmul(x, 8, act="gelu"),
                 "layernorm": lambda: b.layernorm(x),
                 "softmax": lambda: b.softmax(x)}[kind]()
            b.mark_output(y)
            outs.append((b.build(), b))
        (g, b), (gj, bj) = outs
        xin = np.random.default_rng(1).normal(
            size=(3,) + g.inputs[0].shape).astype(np.float32)
        plan = lower_plan(None, g, None, b._weights, FLOAT_SEMANTICS,
                          capacity=4, device="cpu")
        want = japi.compile((gj, bj), cache=False).plan_for(4).run(
            {gj.inputs[0].name: xin}, n=3)
        _within_tol(plan.run({g.inputs[0].name: xin}, n=3), want, kind)
        m = tapi.compile((g, b), cache=False, device="cpu")
        _within_tol({k: v[None] for k, v in m(xin[0]).items()},
                    {k: v[:1] for k, v in want.items()}, kind)


@pytest.mark.parametrize("act", ["none", "relu6", "hswish", "gelu", "leaky"])
def test_k1_nk_plain_version_on_strided_views(act):
    """ops.neutron_matmul_nk on the CPU (K1's plain version): a strided
    4-D view of x, an output written in place into a wider buffer, held
    to numpy's float64 product (f32 accumulation error only)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, 9, 9, 40)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=24).astype(np.float32))
    xin = x[:, ::2, ::2, :]                  # (3, 5, 5, 40) strided
    buf = torch.zeros((3, 30, 24))
    out = buf[:, :25]                        # rows at a pitch, in place
    ops.neutron_matmul_nk(xin, wt, bias, act, out)
    want = ref.ir_activation(torch.from_numpy(
        xin.reshape(3, 25, 40).double().numpy() @ wt.double().numpy().T
        + bias.double().numpy()), act)
    assert torch.allclose(out.double(), want.double(), atol=1e-4, rtol=1e-5)
    assert bool((buf[:, 25:] == 0).all())
