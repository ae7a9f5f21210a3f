"""The port's int8 vision plan replay on the CPU against the JAX package.

The same graphs, inputs and quantized models go through the reference
(``repro``) and the port (``repro_torch``), with inputs from numpy with a
fixed seed:

  * graphs and PTQ: every vision model's fingerprint, and the qparams and
    integer weights of mobilenet_v2 and resnet50_v1, equal;
  * K1's plain version against the Pallas kernel in interpret mode (the
    sweep and tolerances of ``tests/test_kernels.py``), and its plan
    epilogue against the reference's numpy expression;
  * the plan: stored integers ``array_equal`` to the reference plan's at
    batch 1, 3, 8 and 5 in an 8-plan, where every activation of the graph
    is piecewise linear; elsewhere within ``plan_parity_tol`` decoded.
"""
import numpy as np
import pytest
import torch

import repro.api as api
from repro import quant as jquant
from repro.core.execplan import assign_slots as j_assign_slots
from repro.core.ir import _apply_act as j_apply_act
from repro.frontends import vision as jvision
from repro.kernels import ops as jops
from repro.quant.qparams import quantize as j_quantize
from repro_torch.core import execplan as t_execplan
from repro_torch.core.execplan import lower_plan
from repro_torch.core.ir import Graph as TGraph, Op as TOp, QParams as TQP
from repro_torch.core.ir import Tensor as TTensor
from repro_torch.frontends import vision as tvision
from repro_torch.kernels import neutron_matmul as t_k1
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import IR_ACTIVATIONS
from repro_torch import quant as tquant
from repro_torch.quant import QuantSemantics
from repro_torch.quant.convert import qparams_to_numpy, quantized_from_numpy

from test_execplan import random_graph

PIECEWISE_LINEAR = ("none", "relu", "relu6", "hswish", "hsigmoid", "leaky")
VISION = ("mobilenet_v2", "resnet50_v1")


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------
# graphs and PTQ
# --------------------------------------------------------------------------


def test_vision_model_names_equal():
    assert sorted(tvision.VISION_MODELS) == sorted(jvision.VISION_MODELS)


@pytest.mark.parametrize("name", sorted(jvision.VISION_MODELS))
def test_vision_graph_fingerprint_equal(name):
    gj, bj = jvision.build(name, res_scale=0.25)
    gt, bt = tvision.build(name, res_scale=0.25)
    assert gt.fingerprint() == gj.fingerprint()
    assert sorted(bt._weights) == sorted(bj._weights)
    for k, v in bj._weights.items():
        assert np.array_equal(bt._weights[k], v), k


@pytest.fixture(scope="module")
def quantized():
    """Per vision model: the reference's and the port's PTQ at
    res_scale 0.25, and the reference's plan (capacity 8)."""
    out = {}
    for name in VISION:
        _, _, qmj = jvision.build_quantized(name, res_scale=0.25)
        _, _, qmt = tvision.build_quantized(name, res_scale=0.25)
        plan = api.compile(qmj, cache=False).plan_for(8)
        out[name] = (qmj, qmt, plan)
    return out


@pytest.mark.parametrize("name", VISION)
def test_ptq_qparams_and_weights_equal(quantized, name):
    qmj, qmt, _ = quantized[name]
    assert qmt.graph.fingerprint() == qmj.graph.fingerprint()
    want, got = qparams_to_numpy(qmj.graph), qparams_to_numpy(qmt.graph)
    assert sorted(got) == sorted(want)
    for k, (s, z, bits, axis) in want.items():
        gs, gz, gbits, gaxis = got[k]
        assert (gbits, gaxis) == (bits, axis), k
        assert np.array_equal(gs, s) and gs.dtype == s.dtype, k
        assert np.array_equal(gz, z), k
    assert sorted(qmt.qweights) == sorted(qmj.qweights)
    for k, v in qmj.qweights.items():
        assert qmt.qweights[k].dtype == v.dtype
        assert np.array_equal(qmt.qweights[k], v), k
    assert qmt.calib_error == qmj.calib_error


# --------------------------------------------------------------------------
# K1 plain version against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------


def _bf16_pair(a):
    """The same bf16 values for JAX (ml_dtypes) and torch."""
    jb = a.astype("bfloat16")
    return jb, _t(jb.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (100, 300, 70),
                                   (128, 512, 128), (33, 65, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_matches_pallas_shapes(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    if dtype == "bfloat16":
        (xj, xt), (wj, wt) = _bf16_pair(x), _bf16_pair(w)
    else:
        xj, xt, wj, wt = x, _t(x), w, _t(w)
    want = np.asarray(jops.neutron_matmul(xj, wj, impl="pallas"),
                      np.float32)
    got = tops.neutron_matmul(xt, wt)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    tol = 3e-2 if dtype == "bfloat16" else None
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=tol or 2e-3, rtol=tol or 1e-3)


@pytest.mark.parametrize("act", ["none", "relu", "relu6", "silu", "gelu",
                                 "sqrelu", "mish", "sigmoid"])
def test_k1_plain_matches_pallas_activations(act):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    want = jops.neutron_matmul(x, w, bias=b, act=act, impl="pallas")
    got = tops.neutron_matmul(_t(x), _t(w), bias=_t(b), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3,
                               rtol=1e-3)


def test_k1_plain_matches_pallas_int8_requant():
    rng = np.random.default_rng(11)
    x = rng.integers(-128, 128, size=(64, 256)).astype(np.int8)
    w = rng.integers(-128, 128, size=(256, 96)).astype(np.int8)
    want = jops.neutron_matmul(x, w, scale=np.float32(0.02), act="relu",
                               out_scale=0.7, impl="pallas")
    got = tops.neutron_matmul(_t(x), _t(w), scale=np.float32(0.02),
                              act="relu", out_scale=0.7)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_k1_plain_matches_pallas_per_channel_scale():
    rng = np.random.default_rng(13)
    x = rng.integers(-64, 64, size=(16, 128)).astype(np.int8)
    w = rng.integers(-64, 64, size=(128, 32)).astype(np.int8)
    sc = rng.uniform(0.001, 0.1, size=(32,)).astype(np.float32)
    want = jops.neutron_matmul(x, w, scale=sc, impl="pallas")
    got = tops.neutron_matmul(_t(x), _t(w), scale=_t(sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-4)


# --------------------------------------------------------------------------
# K1's plan epilogue against the reference's numpy expression
# --------------------------------------------------------------------------


#: output scale of the "ties" case per activation (default 1/2); see the
#: docstring below
TIE_SCALE = {"hswish": 1 / 16, "sigmoid": 1.0}


def epilogue_case(act: str, case: str):
    """Operands of one plan-epilogue case: x (2, M, K) and w (N, K) int8,
    bias int32, sc, s_out, zp.  In the "ties" case acc + bias is a small
    integer (zero on a whole row), sc = 1/4 and s_out a power of two, so
    that act(y) / s_out lands exactly on k + 0.5 (where half-to-even
    rounding decides) for every activation: at half-integers y for the
    piecewise-linear ones, y * (y + 3) / 6 = 15/32 at y = 3/4 for hswish
    (s_out 1/16), sigmoid(0) = 1/2 (s_out 1), and y itself once silu,
    gelu and mish saturate (y > 17).  "random" draws sc per channel and
    a nonzero output zero point."""
    rng = np.random.default_rng(IR_ACTIVATIONS.index(act))
    M, K, N = 67, 27, 40            # K not a multiple of 4, as the stem
    x = rng.integers(-128, 128, size=(2, M, K)).astype(np.int8)
    w = rng.integers(-127, 128, size=(N, K)).astype(np.int8)
    if case == "ties":
        x = (x // 32).astype(np.int8)
        x[:, 0] = 0
        w = (w // 32).astype(np.int8)
        bias = rng.integers(-20, 21, size=(N,)).astype(np.int32)
        bias[:4] = 0
        sc = np.full((N,), 0.25, np.float32)
        return x, w, bias, sc, np.float32(TIE_SCALE.get(act, 0.5)), 0
    bias = rng.integers(-5000, 5000, size=(N,)).astype(np.int32)
    sc = rng.uniform(1e-4, 5e-3, size=(N,)).astype(np.float32)
    return x, w, bias, sc, np.float32(0.037), -7


@pytest.mark.parametrize("act", IR_ACTIVATIONS)
@pytest.mark.parametrize("case", ["ties", "random"])
def test_k1_plan_epilogue_matches_numpy(act, case):
    """K1's plain version against ``quantize(_apply_act((acc +
    bias).astype(f32) * sc, act), qp)`` as ``quant/execplan.py``
    computes it: equal for the piecewise-linear activations, at most one
    step apart (counted) for the exp/tanh ones."""
    x, w, bias, sc, s_out, zp = epilogue_case(act, case)
    qp = TQP(s_out, np.int64(zp), bits=8)
    acc = np.einsum("bmk,nk->bmn", x.astype(np.float64),
                    w.astype(np.float64))
    y = (acc + bias).astype(np.float32) * sc
    want = j_quantize(j_apply_act(y, act), qp)
    out = torch.empty(want.shape, dtype=torch.int8)
    got = tops.neutron_matmul_plan(_t(x), _t(w), _t(bias), _t(sc), act,
                                   float(s_out), zp, -128, 127, out).numpy()
    if case == "ties":
        v = np.asarray(j_apply_act(y, act), np.float32) / s_out
        ties = (v - np.floor(v) == 0.5) & (np.abs(v) < 127)
        assert ties.sum() > 0, f"{act}: no value lands on k + 0.5"
    diff = np.abs(got.astype(int) - want.astype(int))
    if act in PIECEWISE_LINEAR:
        assert np.array_equal(got, want)
    else:
        assert diff.max() <= 1, f"{act}: {int((diff > 0).sum())} of " \
            f"{diff.size} elements differ by {diff.max()}"
        print(f"{act} {case}: {int((diff > 0).sum())} of {diff.size} "
              f"elements one step apart")


def division_boundary_case(n: int = 512, seed: int = 0):
    """Per column n: an int32 bias b and a rescale sc with y = f32(b) * sc
    within an ulp of (k + 0.5) * s_out, so that a correctly rounded
    division by s_out and a multiply by its float32 reciprocal round to
    different integers on about a tenth of the columns."""
    rng = np.random.default_rng(seed)
    s_out = np.float32(0.037)
    bias = rng.integers(1000, 100000, size=n).astype(np.int32)
    k = rng.integers(-100, 100, size=n)
    sc = ((k + 0.5) * float(s_out) / bias).astype(np.float32)
    return bias, sc, s_out


def test_plan_divisions_are_correctly_rounded():
    """K1's plain version and ``quantize_t`` divide as numpy does where a
    reciprocal multiply would round the other way."""
    from repro_torch.quant.qparams import quantize_t
    bias, sc, s_out = division_boundary_case()
    y = bias.astype(np.float32) * sc
    flips = np.round(y / s_out) != np.round(y * (np.float32(1) / s_out))
    assert flips.sum() > 10
    qp = TQP(s_out, np.int64(0), bits=8)
    want = j_quantize(y, qp)
    n = len(bias)
    got = tops.neutron_matmul_plan(
        _t(np.zeros((1, 1, 4), np.int8)), _t(np.zeros((n, 4), np.int8)),
        _t(bias), _t(sc), "none", float(s_out), 0, -128, 127,
        torch.empty((1, 1, n), dtype=torch.int8))
    assert np.array_equal(got.numpy()[0, 0], want)
    assert np.array_equal(quantize_t(_t(y), qp).numpy(), want)


def test_k1_plan_reads_strided_rows_and_writes_in_place():
    """A (batch, R, C, K) strided view (a stride-2 1x1 conv on an arena
    slot) gives the same rows as its contiguous copy; the output lands
    in the given view of a wider buffer."""
    rng = np.random.default_rng(3)
    slot = _t(rng.integers(-128, 128, size=(3, 9, 9, 20)).astype(np.int8))
    w = _t(rng.integers(-127, 128, size=(12, 20)).astype(np.int8))
    sc = _t(np.full((12,), 1e-3, np.float32))
    xin = slot[:, ::2, ::2, :]
    arena = torch.zeros((3, 25 * 12 + 64), dtype=torch.int8)
    out = arena[:, 64:].view(3, 25, 12)
    tops.neutron_matmul_plan(xin, w, None, sc, "relu", 0.05, 3, -128, 127,
                             out)
    want = tops.neutron_matmul_plan(xin.contiguous().view(3, 25, 20), w,
                                    None, sc, "relu", 0.05, 3, -128, 127,
                                    torch.empty((3, 25, 12),
                                                dtype=torch.int8))
    assert torch.equal(arena[:, 64:].view(3, 25, 12), want)
    assert not arena[:, :64].any()


def test_k1_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 4), dtype=torch.int8)
    n0 = t_k1.launches
    with pytest.raises(ValueError, match="CUDA"):
        t_k1.neutron_matmul(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        t_k1.neutron_matmul_plan(x[None], w.t().contiguous(), None,
                                 torch.ones(1), "none", 1.0, 0, -128, 127,
                                 torch.empty((1, 4, 4), dtype=torch.int8))
    with pytest.raises(TypeError):
        t_k1.neutron_matmul_plan(x[None].float(), w.t().contiguous(), None,
                                 torch.ones(1), "none", 1.0, 0, -128, 127,
                                 torch.empty((1, 4, 4), dtype=torch.int8))
    assert t_k1.launches == n0


# --------------------------------------------------------------------------
# the plan against the reference plan
# --------------------------------------------------------------------------


def _to_port(g, weights):
    """The port's copy of a reference graph (float32, same structure)."""
    ng = TGraph(g.name)
    for t in g.tensors.values():
        ng.tensors[t.name] = TTensor(t.name, t.shape, t.kind, t.dtype,
                                     t.producer, list(t.consumers), t.scale)
    for op in g.ops:
        nop = TOp(op.name, op.kind, list(op.inputs), list(op.outputs),
                  dict(op.attrs))
        ng.ops.append(nop)
        ng._op_index[nop.name] = nop
    assert ng.fingerprint() == g.fingerprint()
    return ng, dict(weights)


def _piecewise_linear(g) -> bool:
    return all(op.attrs.get("act", "none") in PIECEWISE_LINEAR
               for op in g.ops)


def _compare_plans(ref_plan, qmt, seed):
    sem = QuantSemantics(qmt)
    g = qmt.graph
    plan = lower_plan(None, g, None, qmt.weights_f, sem, capacity=8,
                      device="cpu")
    inp = g.inputs[0]
    xs = np.random.default_rng(seed + 1000).normal(
        size=(8,) + inp.shape).astype(np.float32)
    exact = _piecewise_linear(g)
    for n in (1, 3, 8, 5):
        want = ref_plan.run({inp.name: xs[:n]}, n=n, decode=False)
        got = plan.run({inp.name: xs[:n]}, n=n, decode=False)
        for name, w in want.items():
            gi = got[name].numpy()
            if exact:
                assert np.array_equal(gi, w), f"{name} at batch {n}"
            else:
                err = np.abs(sem.decode(name, got[name]).numpy()
                             - ref_plan.semantics.decode(name, w)).max()
                assert err <= sem.plan_parity_tol(name), (name, n, err)
    return exact


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_plan_matches_reference_random_graphs(seed, weight_dtype):
    gj, bj = random_graph(seed)
    gt, wt = _to_port(gj, bj._weights)
    m = api.compile((gj, bj), precision="int8", weight_dtype=weight_dtype,
                    cache=False)
    cal = tquant.synthetic_calibration(gt, samples=4, seed=0)
    qmt = tquant.quantize_graph(gt, wt, tquant.calibrate(gt, wt, cal),
                                weight_dtype=weight_dtype)
    tquant.measure_quant_error(qmt, cal)
    assert qmt.graph.fingerprint() == m.graph.fingerprint()
    _compare_plans(m.plan_for(8), qmt, seed)


@pytest.mark.parametrize("name", VISION)
@pytest.mark.parametrize("via", ["port_ptq", "from_numpy"])
def test_plan_matches_reference_vision(quantized, name, via):
    qmj, qmt, ref_plan = quantized[name]
    if via == "from_numpy":
        g, _ = tvision.build(name, res_scale=0.25)
        qmt = quantized_from_numpy(
            g, qparams_to_numpy(qmj.graph), qmj.qweights,
            qmj.graph.fingerprint(), qmj.weights_f, qmj.calib_error)
    assert _compare_plans(ref_plan, qmt, 0)       # relu/relu6/none: exact


def test_quantized_from_numpy_refuses_another_graph(quantized):
    qmj = quantized["mobilenet_v2"][0]
    g, _ = tvision.build("mobilenet_v1", res_scale=0.25)
    with pytest.raises(ValueError):
        quantized_from_numpy(g, qparams_to_numpy(qmj.graph), qmj.qweights,
                             qmj.graph.fingerprint())


# --------------------------------------------------------------------------
# the arena
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_slots_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 5000, size=40)]
    starts = rng.integers(-1, 30, size=40)
    ivs = [(int(s), int(s + rng.integers(0, 10))) for s in starts]
    assert t_execplan.assign_slots(sizes, ivs) == j_assign_slots(sizes, ivs)


def test_plan_views_alias_the_arena(quantized):
    qmt = quantized["mobilenet_v2"][1]
    plan = lower_plan(None, qmt.graph, None, qmt.weights_f,
                      QuantSemantics(qmt), capacity=4, device="cpu")
    name = qmt.graph.outputs[0].name
    view = plan.view(name)
    off = plan.offsets[plan.ids[name]]
    view[2].fill_(7)
    row = plan._arena[2, off:off + view[2].numel()]
    assert bool((row.view(torch.int8) == 7).all())
    assert view.data_ptr() == plan._arena.data_ptr() + off


# --------------------------------------------------------------------------
# the entry point and what is not ported
# --------------------------------------------------------------------------


def test_serve_vision_on_cpu_agrees_with_float_oracle():
    from repro_torch.launch.serve_vision import float_errors, serve_vision
    served = serve_vision("mobilenet_v2", 3, res_scale=0.25, device="cpu",
                          capacity=4, repeats=1, quiet=True)
    out = served.graph.outputs[0].name
    assert served.stored[out].shape == (3, 1, 1, 1000)
    assert served.stored[out].dtype == torch.int8
    assert served.k1_launches == 0          # plain version on the CPU
    for name, (err, tol, scale) in float_errors(served).items():
        assert err <= tol, (name, err, tol)
        assert scale > 0, name


def test_profile_replay_on_cpu_measures_no_device_time():
    from repro_torch.launch.serve_vision import profile_replay, serve_vision
    served = serve_vision("mobilenet_v2", 2, res_scale=0.25, device="cpu",
                          repeats=0, quiet=True)
    out = profile_replay(served, replays=1)
    assert out["device"] == "cpu" and out["wall_ms_per_replay"] > 0
    assert out["device_busy_ms_per_replay"] == "not measured"
    assert out["idle_share"] == "not measured"


def test_serve_vision_raises_without_a_gpu(monkeypatch):
    from repro_torch.launch.serve_vision import serve_vision
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_vision("mobilenet_v2", 1, res_scale=0.25)


def test_unported_paths_raise_naming_their_item():
    """ROADMAP item 8 is done: a causal graph that raised naming it now
    lowers under both semantics, and its int8 plan's stored ints equal
    the reference plan's (the matmul has no activation, so the plan is
    exact)."""
    from repro.core.ir import GraphBuilder as JGraphBuilder
    from repro_torch.core.executor import FLOAT_SEMANTICS
    from repro_torch.core.ir import GraphBuilder
    b = GraphBuilder("causal", seed=0)
    x = b.input((4, 1, 8))
    b.mark_output(b.matmul(x, 8))
    g = b.build()
    lower_plan(None, g, None, b._weights, FLOAT_SEMANTICS, device="cpu")
    cal = tquant.synthetic_calibration(g, samples=1)
    qm = tquant.quantize_graph(g, b._weights,
                               tquant.calibrate(g, b._weights, cal))
    plan = lower_plan(None, g, None, qm.weights_f, QuantSemantics(qm),
                      capacity=2, device="cpu")
    bj = JGraphBuilder("causal", seed=0)
    xj = bj.input((4, 1, 8))
    bj.mark_output(bj.matmul(xj, 8))
    gj = bj.build()
    qmj = jquant.quantize_graph(gj, bj._weights,
                                jquant.calibrate(gj, bj._weights, cal))
    ref_plan = api.compile(qmj, cache=False).plan_for(2)
    xs = np.random.default_rng(0).normal(size=(2, 4, 1, 8)) \
        .astype(np.float32)
    want = ref_plan.run({x: xs}, n=2, decode=False)
    got = plan.run({x: xs}, n=2, decode=False)
    for name, w in want.items():
        assert np.array_equal(got[name].numpy(), w), name
