"""The port's copy of the NPU compiler against the JAX package's, on the CPU.

The same vision graphs go through ``repro.api.compile`` and
``repro_torch.api.compile`` (int8, PTQ inside, res_scale 0.25) and must
give the same compiled program: equal tick counts and DDR bytes (the
table below), equal program / tiling / allocation / format-plan payloads
and ``.rpa`` artifacts that are byte-for-byte equal.  The cost model and
the CP solver are held against the reference on sweeps of their own.

Both sides compile under ``PINNED``: the default options stop each CP at
a wall-clock deadline (``cp_time_limit_s`` 0.6 s), so two compiles of one
graph in one process can give different programs (mobilenet_v2 at 224:
101 then 103 ticks).  With deadlines of 60 s every search ends on its
node-count stall (``cp_stall_nodes``), which is deterministic.  The CPs
are also solved serially (``parallel_cp=False``): the programs are the
same as the fork pool's, and the files running beside these on other
workers keep their cores (a pool of one process per core per compile
made a latency-bounded serving test miss its deadline).

The graphs are split over this file and ``test_torch_compile_detect.py``
so that each file stays near 50 s on one worker (the suite runs
``--dist loadfile``).
"""
import hashlib
import random
import time
import zipfile
from dataclasses import asdict

import numpy as np
import pytest

import repro.api as japi
from repro.core import cpsolver as jcp
from repro.core import npu as jnpu
from repro.core import serialize as jser
from repro.frontends import vision as jvision
from repro.quant import cast_graph as j_cast_graph
import repro_torch.api as tapi
from repro_torch.core import cpsolver as tcp
from repro_torch.core import npu as tnpu
from repro_torch.core import serialize as tser
from repro_torch.core.formats import FORMATS
from repro_torch.frontends import vision as tvision
from repro_torch.quant import cast_graph as t_cast_graph

PINNED = dict(cp_time_limit_s=60.0, monolithic_time_limit_s=60.0,
              parallel_cp=False)

#: (ticks, DDR bytes per request) of each vision graph at res_scale 0.25,
#: int8, under PINNED, as the reference compiles them
EXPECTED = {
    "mobilenet_v1": (53, 4_260_936),
    "mobilenet_v2": (87, 3_546_056),
    "mobilenet_v3_min": (91, 3_959_600),
    "resnet50_v1": (291, 25_617_224),
    "efficientnet_lite0": (83, 4_701_096),
    "efficientdet_lite0": (256, 3_710_956),
    "yolov8n_det": (100, 3_321_472),
    "yolov8s_det": (176, 11_340_272),
    "yolov8n_seg": (113, 3_626_784),
    "mobilenet_v1_ssd": (77, 5_360_476),
    "mobilenet_v2_ssd": (119, 4_582_108),
    "damo_yolo_nl": (124, 5_046_948),
}
GRAPHS = ("mobilenet_v1", "mobilenet_v2", "mobilenet_v3_min", "resnet50_v1",
          "efficientnet_lite0", "yolov8s_det")
PAYLOADS = ("program", "tiling", "allocation", "plan")


class _FixedClock:
    """Stands in for the ``time`` module of ``zipfile``: a zip member's
    header stamps the wall clock (at 2 s resolution), so two saves of one
    model a second apart differ in those bytes alone.  Both sides save
    under this clock."""

    @staticmethod
    def time():
        return 0.0

    @staticmethod
    def localtime(_=None):
        return time.struct_time((2000, 1, 1, 0, 0, 0, 5, 1, 0))


def _summary(api, ser, name, tmp_path, device_kw):
    """Compile ``name`` through one package and reduce the model to what
    the tests compare: ticks, DDR bytes, the four payloads and the
    artifact's size and sha256 (the file is deleted: resnet50_v1's is
    ~325 MB)."""
    m = api.compile(name, precision="int8", res_scale=0.25,
                    options=api.CompilerOptions(**PINNED), cache=False,
                    **device_kw)
    out = {"ticks": len(m.program.ticks), "ddr": m.program.ddr_bytes(),
           "program": ser.program_to_payload(m.program),
           "tiling": ser.tiling_to_payload(m.tiling),
           "allocation": ser.allocation_to_payload(m.allocation),
           "plan": ser.plan_to_payload(m.plan)}
    path = tmp_path / f"{name}.rpa"
    m.save(str(path))
    out["rpa_bytes"] = path.stat().st_size
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    out["rpa_sha256"] = h.hexdigest()
    with zipfile.ZipFile(path) as zf:
        out["members"] = sorted(zf.namelist())
    path.unlink()
    return out


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """``compiled(name) -> (reference summary, port summary)``, computed
    once per graph and module."""
    memo = {}
    tmp = tmp_path_factory.mktemp("rpa")
    mp = pytest.MonkeyPatch()
    mp.setattr(zipfile, "time", _FixedClock)

    def get(name):
        if name not in memo:
            memo[name] = (
                _summary(japi, jser, name, tmp, {}),
                _summary(tapi, tser, name, tmp, {"device": "cpu"}))
        return memo[name]

    yield get
    mp.undo()


def check_ticks_and_ddr_bytes(compiled, name):
    ref, port = compiled(name)
    assert (ref["ticks"], ref["ddr"]) == EXPECTED[name]
    assert (port["ticks"], port["ddr"]) == EXPECTED[name]


def check_payloads(compiled, name):
    ref, port = compiled(name)
    for what in PAYLOADS:
        assert port[what] == ref[what], what


def check_rpa_bytes(compiled, name):
    """Every member, the plan constants (``pl/*``) included, and the
    container bytes equal."""
    ref, port = compiled(name)
    assert port["members"] == ref["members"]
    assert any(m.startswith("arrays/pl/") for m in port["members"])
    assert port["rpa_bytes"] == ref["rpa_bytes"]
    assert port["rpa_sha256"] == ref["rpa_sha256"]


@pytest.mark.parametrize("name", GRAPHS)
def test_ticks_and_ddr_bytes_match_reference(compiled, name):
    check_ticks_and_ddr_bytes(compiled, name)


@pytest.mark.parametrize("name", GRAPHS)
def test_payloads_match_reference(compiled, name):
    check_payloads(compiled, name)


@pytest.mark.parametrize("name", GRAPHS)
def test_rpa_bytes_match_reference(compiled, name):
    check_rpa_bytes(compiled, name)


def test_graphs_cover_the_vision_suite():
    from test_torch_compile_detect import GRAPHS as DETECT
    assert sorted(GRAPHS + DETECT) == sorted(jvision.VISION_MODELS)
    assert sorted(EXPECTED) == sorted(tvision.VISION_MODELS)


# --------------------------------------------------------------------------
# the cost model
# --------------------------------------------------------------------------


CONFIGS = ("NEUTRON_2TOPS", "ENPU_A", "ENPU_B")


@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_compute_job_cost_matches_reference(cfg_name, dtype):
    """Every op of four graphs, each format, four row counts, three
    engine counts and a channel split: equal ``JobCost``s."""
    jcfg, tcfg = getattr(jnpu, cfg_name), getattr(tnpu, cfg_name)
    n = 0
    for name in ("mobilenet_v2", "resnet50_v1", "yolov8n_det",
                 "efficientdet_lite0"):
        gj, _ = jvision.build(name, res_scale=0.25)
        gt, _ = tvision.build(name, res_scale=0.25)
        if dtype == "int8":
            gj, gt = j_cast_graph(gj), t_cast_graph(gt)
        for oj in gj.ops:
            ot = gt.op(oj.name)
            out = gj.tensors[oj.outputs[0]].shape
            h = out[0] if len(out) == 3 else 1
            c = out[-1]
            for fmt in FORMATS:
                for out_h in sorted({1, max(1, h // 3), max(1, h // 2), h}):
                    for engines, out_c in ((None, None), (1, None),
                                           (2, max(1, c // 2))):
                        want = jnpu.compute_job_cost(jcfg, gj, oj, out_h,
                                                     fmt, engines, out_c)
                        got = tnpu.compute_job_cost(tcfg, gt, ot, out_h,
                                                    fmt, engines, out_c)
                        assert asdict(got) == asdict(want), \
                            (name, oj.name, fmt, out_h, engines, out_c)
                        n += 1
    assert n > 1000


@pytest.mark.parametrize("cfg_name", CONFIGS)
def test_dma_cost_matches_reference(cfg_name):
    jcfg, tcfg = getattr(jnpu, cfg_name), getattr(tnpu, cfg_name)
    rng = np.random.default_rng(0)
    sizes = [0, 1, 63, 64, 65, 4096] + [int(v) for v in
                                        rng.integers(1, 1 << 24, 200)]
    for nb in sizes:
        for kind in ("ddr", "tcm"):
            assert tnpu.dma_cost(tcfg, nb, kind) == \
                jnpu.dma_cost(jcfg, nb, kind), (nb, kind)
        for rt in (True, False):
            assert tnpu.cross_window_spill_cost(tcfg, nb, rt) == \
                jnpu.cross_window_spill_cost(jcfg, nb, rt), (nb, rt)
    assert tnpu.effective_tops(tcfg, 10 ** 9, 1e6) == \
        jnpu.effective_tops(jcfg, 10 ** 9, 1e6)
    assert tnpu.cycles_to_ms(tcfg, 12345) == jnpu.cycles_to_ms(jcfg, 12345)


# --------------------------------------------------------------------------
# the CP solver
# --------------------------------------------------------------------------


def _random_model(cp, seed: int, max_terms: bool):
    """The random 0-1 model of ``tests/test_cpsolver.py``, built through
    one package's ``CPModel`` from a seeded ``random.Random``."""
    rng = random.Random(seed)
    n_vars = rng.randint(2, 10)
    m = cp.CPModel("rand")
    for i in range(n_vars):
        m.bool(f"x{i}")
    for c in range(rng.randint(1, 6)):
        k = rng.randint(1, min(4, n_vars))
        vs = rng.sample(range(n_vars), k)
        coefs = [rng.randint(-3, 3) or 1 for _ in vs]
        m.add(list(zip(vs, coefs)), "<=", rng.randint(-2, 4), f"c{c}")
    m.minimize([(v, rng.randint(-5, 5)) for v in range(n_vars)
                if rng.random() < 0.8])
    if max_terms:
        vs = rng.sample(range(n_vars), rng.randint(1, n_vars))
        m.max_terms = [cp.MaxTerm([
            (rng.randint(0, 3), [(v, rng.randint(0, 4)) for v in vs]),
            (rng.randint(0, 3), [(v, rng.randint(0, 4)) for v in vs])])]
    return m


@pytest.mark.parametrize("engine", ["incremental", "reference"])
@pytest.mark.parametrize("max_terms", [False, True])
def test_cpsolver_matches_reference_and_brute_force(engine, max_terms):
    """40 random models: the port's solution, objective and search
    (nodes) equal the reference's, and the objective equals the port's
    exhaustive ``brute_force``."""
    for seed in range(40):
        mj = _random_model(jcp, seed, max_terms)
        mt = _random_model(tcp, seed, max_terms)
        want = jcp.ENGINES[engine](mj, time_limit_s=5.0)
        got = tcp.ENGINES[engine](mt, time_limit_s=5.0)
        assert (got.values, got.objective, got.feasible, got.optimal,
                got.nodes) == (want.values, want.objective, want.feasible,
                               want.optimal, want.nodes), seed
        exact = tcp.brute_force(mt)
        assert got.feasible == exact.feasible, seed
        if exact.feasible:
            assert got.objective == exact.objective, seed
            assert not mt.check([got.values[v] for v in range(mt.n_vars)])


def test_solve_many_matches_reference():
    """A batch through ``solve_many`` (the fork pool, or serially when
    the process has threads) gives the reference's solutions in order."""
    tasks_j = [jcp.SolveTask(_random_model(jcp, s, True), 5.0)
               for s in range(6)]
    tasks_t = [tcp.SolveTask(_random_model(tcp, s, True), 5.0)
               for s in range(6)]
    want = jcp.solve_many(tasks_j)
    got = tcp.solve_many(tasks_t)
    assert [(s.values, s.objective) for s in got] == \
        [(s.values, s.objective) for s in want]
