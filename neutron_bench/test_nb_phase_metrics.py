"""The readers of a batch's host phases (``stage_ms``, ``copy_in_gb_s``,
``copy_back_ms``, ``settle_ms``, ``idle_in_stage``) on a synthetic trace,
on a program whose spans carry no batch id, and in a traced run of a
closed cell on the CPU."""
import pytest

from neutron_bench.conftest import last_json
from neutron_bench.harness import cells
from neutron_bench.harness.trace import Trace
from neutron_bench.test_nb_metrics import _run, read

PHASE_METRICS = ("stage_ms.closed", "copy_in_gb_s.closed",
                 "copy_back_ms.closed", "settle_ms.closed",
                 "idle_in_stage.closed")


def _span(name, a, b, batch, **args):
    return (name, "serving", a, b, 1, dict(args, batch=batch))


def _trace(with_ids=True):
    tr = Trace(window=(0.0, 1.0))
    # device busy [0.1, 0.3] and [0.5, 0.7]: idle [0, 0.1], [0.3, 0.5],
    # [0.7, 1.0]
    tr.device = [(0.1, 0.3, "k1", 1), (0.5, 0.7, "k2", 2)]
    b1, b2, b3 = (1, 2, 3) if with_ids else (None, None, None)
    tr.spans = [
        _span("batch", 0.0, 0.4, b1, n=32),
        _span("stage.stack", 0.0, 0.05, b1),
        _span("stage.copy_in", 0.05, 0.15, b1, bytes=2e8),
        _span("stage.encode", 0.15, 0.2, b1),
        ("conv_3@op", "plan", 0.2, 0.3, 1, None),
        _span("decode", 0.3, 0.35, b1),
        _span("copy_back", 0.35, 0.38, b1),
        _span("settle", 0.4, 0.42, b1),
        _span("batch", 0.45, 0.9, b2, n=32),
        _span("stage.stack", 0.45, 0.5, b2),
        _span("stage.copy_in", 0.5, 0.55, b2, bytes=1e8),
        _span("stage.encode", 0.55, 0.6, b2),
        _span("copy_back", 0.85, 0.88, b2),
        _span("settle", 0.9, 0.93, b2),
        # a batch after the window: none of the per-batch means
        _span("batch", 1.2, 1.5, b3, n=32),
        _span("stage.stack", 1.2, 1.3, b3),
        _span("copy_back", 1.4, 1.5, b3),
    ]
    return tr


def _read_all(tr):
    run = _run([0.0], [0.5], window=(0.0, 1.0), trace=tr)
    return {name: read(name, run) for name in PHASE_METRICS}


def test_phase_readers_on_a_synthetic_trace():
    got = _read_all(_trace())
    assert got["stage_ms.closed"] == pytest.approx((0.2 + 0.15) / 2 * 1e3)
    assert got["copy_in_gb_s.closed"] == pytest.approx(3e8 / 0.15 / 1e9)
    assert got["copy_back_ms.closed"] == pytest.approx(30.0)
    assert got["settle_ms.closed"] == pytest.approx(25.0)
    # staging [0, 0.2], [0.45, 0.6] against idle [0, 0.1], [0.3, 0.5]
    assert got["idle_in_stage.closed"] == pytest.approx(15.0)


def test_phase_readers_read_nothing_without_their_spans():
    assert set(_read_all(None).values()) == {None}
    # the program before the phase spans: batch spans without an id
    got = _read_all(_trace(with_ids=False))
    assert {got[n] for n in PHASE_METRICS[:4]} == {None}
    bare = _trace()
    bare.spans = [s for s in bare.spans if not s[0].startswith("stage.")]
    assert read("idle_in_stage.closed",
                _run([0.0], [0.5], window=(0.0, 1.0), trace=bare)) is None
    no_device = _trace()
    no_device.device = []
    assert read("idle_in_stage.closed",
                _run([0.0], [0.5], window=(0.0, 1.0),
                     trace=no_device)) is None


@pytest.mark.parametrize("name", PHASE_METRICS)
def test_phase_reader_units(name):
    unit = cells.metric(name).UNIT
    assert unit == {"copy_in_gb_s.closed": "GB/s",
                    "idle_in_stage.closed": "%"}.get(name, "ms")


def test_phase_readers_in_a_traced_cpu_run(cpu_run):
    """The program's own spans, read in a traced run of the closed cell
    on the CPU, where no device trace exists (``idle_in_stage`` reads
    nothing) and outputs need no copy back (``copy_back_ms`` reads
    nothing)."""
    cell = "mobilenet_v2-int8.closed-b32"
    wl = dict(cells.workload(cell), per_layer=list(PHASE_METRICS))
    rc, out, err = cpu_run(cell, seconds=1.0, trace=1, workload=wl)
    assert rc == 0, err[-2000:]
    metrics = last_json(out)["metrics"]
    assert set(metrics) == {"stage_ms.closed", "copy_in_gb_s.closed",
                            "settle_ms.closed"}
    for name, m in metrics.items():
        assert m["value"] > 0 and m["unit"] == cells.metric(name).UNIT
