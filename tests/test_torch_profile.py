"""``repro_torch.obs.profile`` and ``ExecPlan``'s timing and reporting
members on the CPU (ROADMAP item 9), against the JAX package's.

The reference compiles a graph and saves it; the port loads the same
``.rpa`` (``device="cpu"``); both profile it.  The modeled block comes
from the same program through the copied ``core/program.py``, so the
``modeled`` dicts are equal exactly, and so are each op's modeled cycles
and MACs.  Step labels map to ops: the int8 lowerings of both packages
emit one ``op@op`` step per op, so the per-op kernel counts are equal; the
port's float32 lowering emits one ``op@f32`` step per op (the
reference's splits ops by rows).  The measured block is host time here;
on the card it is CUDA-event time (``tests/test_torch_cuda.py``).
``ExecPlan.stats()`` and ``execution_report()`` are held to the
reference's.
"""
import json

import numpy as np
import pytest

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.core.ir import GraphBuilder as TGraphBuilder
from repro_torch.obs import ProfileReport, trace

from test_execplan import _inputs, random_graph
from test_torch_api import _tiny_graph
from test_torch_vision import _to_port


@pytest.fixture(autouse=True)
def _no_tracer():
    trace.disable()
    yield
    trace.disable()


GRAPHS = {
    "rand5": lambda: random_graph(5),
    "rand1": lambda: random_graph(1),
    "mnv2_r025": lambda: "mobilenet_v2",
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """(key, precision) -> (reference model, the port's load of its
    artifact), built once per module."""
    d = tmp_path_factory.mktemp("profile_rpa")
    memo = {}

    def get(key, precision):
        if (key, precision) not in memo:
            src = GRAPHS[key]()
            kw = {"res_scale": 0.25} if isinstance(src, str) else {}
            mj = japi.compile(src, precision=precision, cache=False, **kw)
            p = mj.save(str(d / f"{key}_{precision}.rpa"))
            memo[(key, precision)] = (mj, tapi.load(p, device="cpu"))
        return memo[(key, precision)]
    return get


def _port_graph(seed):
    """The port's copy of ``random_graph(seed)`` and its weights, as
    ``api.compile``'s source and ``weights=``."""
    gj, bj = random_graph(seed)
    g, w = _to_port(gj, bj._weights)
    return g, w


def _by_op(rep):
    return {o.op: o for o in rep.ops}


@pytest.mark.parametrize("precision", ["int8", "float32"])
@pytest.mark.parametrize("key", sorted(GRAPHS))
def test_profile_matches_reference(pairs, key, precision):
    mj, mt = pairs(key, precision)
    rj = mj.profile(batch=2, runs=1)
    rt = mt.profile(batch=2, runs=1)
    assert isinstance(rt, ProfileReport)
    assert rt.modeled == rj.modeled
    assert (rt.model, rt.precision, rt.batch, rt.runs) == \
        (rj.model, rj.precision, rj.batch, rj.runs)
    oj, ot = _by_op(rj), _by_op(rt)
    assert set(ot) == set(oj)
    for op, o in ot.items():
        assert (o.kind, o.modeled_cycles, o.macs) == \
            (oj[op].kind, oj[op].modeled_cycles, oj[op].macs), op
        assert o.modeled_share == oj[op].modeled_share, op
    assert sum(o.measured_share for o in rt.ops) == pytest.approx(1.0,
                                                                  abs=1e-6)
    steps = mt.plan_for(2).steps
    assert rt.measured["kernels"] == float(len(steps))
    assert sum(o.kernels for o in rt.ops) == len(steps)
    kinds = {k.op: (k.kernels, k.modeled_cycles) for k in rt.kinds}
    kinds_j = {k.op: (k.kernels, k.modeled_cycles) for k in rj.kinds}
    if precision == "int8":
        assert {op: o.kernels for op, o in ot.items()} == \
            {op: o.kernels for op, o in oj.items()}
        assert kinds == kinds_j
    else:
        assert all(o.kernels == 1 for o in rt.ops if o.kernels)
        assert len(steps) == len(mt.graph.ops)
        assert {k: c for k, (_, c) in kinds.items()} == \
            {k: c for k, (_, c) in kinds_j.items()}


def test_profile_correlates_model_and_measurement():
    """``tests/test_obs.py``'s profiler assertions, on the port."""
    g, w = _port_graph(5)
    m = tapi.compile(g, weights=w, precision="int8", cache=False,
                     device="cpu")
    rep = m.profile(batch=2, runs=1)
    assert rep.modeled["latency_ms"] > 0
    assert rep.measured["wall_ms_per_request"] > 0
    assert 0 < rep.modeled["utilization"] <= 1.0
    assert rep.measured["model_vs_actual"] > 0
    assert rep.ops, "per-op attribution must be populated"
    shares = sum(op.measured_share for op in rep.ops)
    assert shares == pytest.approx(1.0, abs=1e-6)
    top = rep.ops[0]
    assert top.kernels >= 1 and top.measured_ms >= 0
    text = rep.render()
    assert "modeled" in text and top.op in text
    d = rep.as_dict()
    json.dumps(d)
    assert d["ops"][0]["op"] == top.op
    # a given sample feed profiles too, and the step times sum within the
    # replay's wall time
    x = _inputs(m.graph, 1, 3)[0]
    rep = m.profile(x, batch=3, runs=2)
    assert rep.measured["kernel_ms_per_request"] <= \
        rep.measured["wall_ms_per_request"]


def test_profile_of_a_cost_model_only_model_raises():
    from repro_torch import quant
    g, b = _tiny_graph(TGraphBuilder)
    m = tapi.compile(quant.cast_graph(g, "int8"), weights=dict(b._weights),
                     cache=False, device="cpu")
    with pytest.raises(RuntimeError, match="cost-model-only"):
        m.profile()


# --------------------------------------------------------------------------
# ExecPlan: step_times, tracer spans, stats(), execution_report()
# --------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["int8", "float32"])
def test_plan_stats_and_execution_report_match_reference(pairs, precision):
    """Equal to the reference's but for ``build_s`` (a clock); at float32
    also ``granularity`` (``"op"``: one step per op here, ``"step"``:
    one per program step there) and with it ``kernels`` and the arena,
    whose live intervals run over the steps."""
    mj, mt = pairs("mnv2_r025", precision)
    pj, pt = mj.plan_for(4), mt.plan_for(4)
    sj, st = pj.stats(), pt.stats()
    assert set(st) == set(sj)
    differ = {k for k in sj if k != "build_s" and st[k] != sj[k]}
    if precision == "int8":
        assert differ == set()
    else:
        assert differ <= {"granularity", "kernels", "arena_bytes",
                          "arena_total_bytes"}
        assert (st["granularity"], sj["granularity"]) == ("op", "step")
        assert st["kernels"] == len(mt.graph.ops)
    x = np.stack(_inputs(mt.graph, 3, 1))
    inp = mt.graph.inputs[0].name
    oj = pj.run({inp: x}, n=3)
    ot = pt.run({inp: x}, n=3)
    rj, rt = pj.execution_report(oj, n=3), pt.execution_report(ot, n=3)
    for f in ("max_err", "ticks", "ddr_bytes", "ok", "batch", "engine"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert set(rt.outputs) == set(rj.outputs)


def test_step_times_and_plan_spans():
    """``run(step_times=[])`` appends one (label, seconds) per step, in
    step order; with the tracer armed each step is a ``plan`` span
    carrying the caller's trace id; outputs equal the untimed loop's."""
    g, w = _port_graph(1)
    m = tapi.compile(g, weights=w, precision="int8", cache=False,
                     device="cpu")
    plan = m.plan_for(2)
    x = np.stack(_inputs(m.graph, 2, 0))
    feed = {m.graph.inputs[0].name: x}
    want = plan.run(feed, n=2)
    times = []
    got = plan.run(feed, n=2, step_times=times)
    assert [lab for lab, _ in times] == [st.label for st in plan.steps]
    assert all(dt >= 0.0 for _, dt in times)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k].numpy())
    tr = trace.enable()
    plan.run(feed, n=2, trace_id=41)
    trace.disable()
    spans = [e for e in tr.events() if e[1] == "plan"]
    assert [e[0] for e in spans] == [st.label for st in plan.steps]
    assert {e[6] for e in spans} == {41}
