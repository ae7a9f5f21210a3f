"""``repro_torch.api.Session`` and its thread worker pool on the CPU
(ROADMAP item 6b), against the JAX package's ``repro.api.Session``.

The thread-pool and synchronous cases of ``tests/test_robust.py``,
``tests/test_api.py`` (multi-model precisions, artifacts) and
``tests/test_obs.py`` (histograms, metrics exposition, the pooled trace
round trip) run on the port with ``device="cpu"``, where the plans take
K1's plain version.  Served outputs are CPU tensors, held to the
interpreter within ``plan_parity_tol`` (one output step for int8,
``executor.float_plan_tol`` for float32) and, where both packages serve
the same requests, to the reference Session: int8 outputs equal,
float32 within ``float_plan_tol``.  The process-pool and frame cases of
``test_robust.py`` are in ``tests/test_torch_procpool.py``.  Also here:
the plan cache and the kernel build under threads.
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as api
import repro_torch.runtime.chaos as chaos
from repro.core import program_cache_clear as j_cache_clear
from repro.core import program_cache_configure as j_cache_configure
from repro.core import program_cache_info as j_cache_info
from repro_torch.api import (DeadlineExceeded, FlushError, Overloaded,
                             WorkerLost)
from repro_torch.core import (program_cache_clear, program_cache_configure,
                              program_cache_info)
from repro_torch.core.executor import float_plan_tol
from repro_torch.core.ir import GraphBuilder as TGraphBuilder
from repro_torch.kernels import _build
from repro_torch.obs import trace
from repro_torch.obs.metrics import LogHistogram, MetricsRegistry
from repro_torch.obs.trace import validate_chrome_trace
from repro_torch.runtime.fault import FaultMonitor
from repro_torch.runtime.serving import (CircuitBreaker, LatencyHistogram,
                                         ServerPool, Ticket)

from test_execplan import _inputs, random_graph
from test_torch_api import _input, _tiny_graph
from test_torch_vision import _to_port


@pytest.fixture(autouse=True)
def _isolated_caches():
    saved = program_cache_info(), j_cache_info()
    for clear, configure in ((program_cache_clear, program_cache_configure),
                             (j_cache_clear, j_cache_configure)):
        clear()
        configure(max_entries=64, max_bytes=None, disk_dir=None)
    trace.disable()
    yield
    trace.disable()
    for (clear, configure), s in zip(
            ((program_cache_clear, program_cache_configure),
             (j_cache_clear, j_cache_configure)), saved):
        clear()
        configure(max_entries=s["max_entries"], max_bytes=s["max_bytes"],
                  disk_dir=s["disk_dir"])


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: its CPU work is small,
    and the suite runs files side by side, some of them timing-sensitive
    (the reference's deadline and tracing-overhead tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _graph(seed):
    """The port's copy of ``test_execplan.random_graph(seed)``."""
    gj, bj = random_graph(seed)
    return _to_port(gj, bj._weights)


def _add(sess, seed, name, precision="int8"):
    g, w = _graph(seed)
    return sess.add(g, weights=w, name=name, precision=precision)


def _session(precision="int8", **kw):
    kw.setdefault("max_batch", 4)
    sess = api.Session(device="cpu", **kw)
    _add(sess, 0, "m0", precision)
    return sess


def _feed(sess, name="m0", seed=0):
    return _inputs(sess[name].graph, 1, seed)[0]


def _check_output(sess, name, out, feed):
    """A served output: CPU tensors within the plan's parity tolerance of
    the interpreter."""
    want = sess[name](feed, engine="interp")
    for k, w in want.items():
        got = out[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        w = w.numpy()
        err = float(np.max(np.abs(got.numpy() - w)))
        assert err <= sess[name].semantics.plan_parity_tol(k, w), \
            f"{name}/{k}: served output diverged from oracle by {err}"


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# --------------------------------------------------------------------------
# primitives: fault monitor, histogram, breaker
# --------------------------------------------------------------------------


def test_fault_monitor_dead_hosts_at_time_zero():
    mon = FaultMonitor(n_hosts=2, timeout_s=1.0)
    assert mon.dead_hosts(now=0.0) == []


def test_fault_monitor_beat_tolerates_unknown_host():
    mon = FaultMonitor(n_hosts=1, timeout_s=1.0)
    mon.beat(7, step=3, step_time_s=0.5)
    assert 7 in mon.beats and mon.step_times[7] == [0.5]
    mon.retire(7)
    assert 7 not in mon.beats and 7 not in mon.step_times
    mon.retire(7)


def test_fault_monitor_retire_tombstone_drops_late_beats():
    mon = FaultMonitor(n_hosts=0, timeout_s=1.0)
    mon.register(3)
    mon.beat(3, step=0, step_time_s=0.1)
    mon.retire(3)
    mon.beat(3, step=1, step_time_s=0.1)
    assert 3 not in mon.beats
    assert mon.dead_hosts(now=99.0) == []
    mon.register(3)
    mon.beat(3, step=2, step_time_s=0.1)
    assert 3 in mon.beats


def test_latency_histogram_percentiles():
    h = LatencyHistogram()
    for ms in range(1, 101):
        h.record(float(ms))
    snap = h.snapshot()
    assert snap["count"] == 100
    assert 45 <= snap["p50_ms"] <= 56
    assert 90 <= snap["p99_ms"] <= 110
    assert snap["max_ms"] == 100.0
    assert abs(snap["mean_ms"] - 50.5) < 1e-6


def test_loghistogram_percentiles_and_snapshot():
    h = LogHistogram()
    for v in [1.0] * 90 + [100.0] * 10:
        h.record(v)
    assert h.count == 100
    assert h.percentile(50) == pytest.approx(1.0, rel=0.10)
    assert h.percentile(99) == pytest.approx(100.0, rel=0.10)
    snap = h.snapshot()
    assert set(snap) == {"count", "mean_ms", "p50_ms", "p99_ms", "max_ms"}
    assert snap["max_ms"] == 100.0
    assert h.sum_ms == h.sum and h.max_ms == h.max


def test_loghistogram_empty_and_clamping():
    h = LogHistogram()
    assert h.percentile(99) == 0.0
    h.record(-5.0)
    assert h.percentile(50) <= h._lo


def test_registry_render_matches_reference():
    """The port's registry renders what the reference's renders."""
    from repro.obs.metrics import MetricsRegistry as JRegistry
    texts = []
    for reg in (MetricsRegistry(), JRegistry()):
        reg.counter("repro_req_total", "requests", ("model",)).inc(
            3, model="a")
        reg.histogram("repro_lat_ms", "latency", ("model",)).observe(
            12.5, model="a")
        reg.gauge("repro_depth", "queue depth").set(4)
        texts.append(reg.render())
    assert texts[0] == texts[1]


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(threshold=3, cooldown_s=1.0)
    assert br.allow_plan()
    assert not br.record_failure(now=0.0)
    assert not br.record_failure(now=0.0)
    br.record_success()
    assert not br.record_failure(now=0.0)
    assert not br.record_failure(now=0.0)
    assert br.record_failure(now=0.0)
    assert br.state == "open" and not br.allow_plan()
    assert not br.try_probe(now=0.5)
    assert br.try_probe(now=1.5)
    assert br.state == "half_open"
    assert not br.try_probe(now=1.5)
    br.probe_failed(now=1.5)
    assert br.state == "open"
    assert br.try_probe(now=3.0)
    br.probe_succeeded()
    assert br.state == "closed" and br.allow_plan()
    assert br.snapshot()["trips"] == 1 and br.snapshot()["recoveries"] == 1


def test_flip_outputs_perturbs_a_copy_of_a_tensor():
    out = {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.int8)}
    bad = chaos.flip_outputs(out)
    assert float(bad["a"][0]) == 1e3 and float(out["a"][0]) == 0.0
    assert bad["b"] is out["b"]


# --------------------------------------------------------------------------
# admission control + deadlines (sync mode)
# --------------------------------------------------------------------------


def test_bounded_queue_sheds_with_retry_hint():
    sess = _session(max_queue=5)
    x = _feed(sess)
    for _ in range(5):
        sess.submit("m0", x)
    with pytest.raises(Overloaded) as ei:
        sess.submit("m0", x)
    assert ei.value.model == "m0"
    assert ei.value.queue_depth == 5
    assert ei.value.retry_after_ms >= 1.0
    assert sess.flush() == 5
    assert sess.stats()["models"]["m0"]["shed"] == 1
    sess.submit("m0", x)
    sess.flush()


def test_deadline_expiry_ordering():
    sess = _session()
    x = _feed(sess)
    t_dead = sess.submit("m0", x, deadline_ms=0.0)
    assert t_dead.done and isinstance(t_dead.error, DeadlineExceeded)
    before = sess.stats()["models"]["m0"]["requests"]
    with chaos.inject() as c:
        t_soon = sess.submit("m0", x, deadline_ms=1.0)
        t_late = sess.submit("m0", x, deadline_ms=10_000.0)
        t_none = sess.submit("m0", x)
        c.skew_clock(0.5)
        sess.flush("m0")
    with pytest.raises(DeadlineExceeded) as ei:
        t_soon.result()
    assert ei.value.late_ms > 0
    _check_output(sess, "m0", t_late.result(), x)
    _check_output(sess, "m0", t_none.result(), x)
    st = sess.stats()["models"]["m0"]
    assert st["deadline_misses"] == 2
    assert st["requests"] == before + 2


def test_per_model_flush_does_not_drain_other_models():
    sess = _session()
    _add(sess, 1, "m1")
    t0 = sess.submit("m0", _feed(sess, "m0"))
    t1 = sess.submit("m1", _feed(sess, "m1"))
    assert sess.flush("m0") == 1
    assert t0.done and not t1.done
    t1.result()
    assert sess.queue_depth == 0


def test_flush_aggregates_errors_and_drains_every_model():
    sess = _session()
    _add(sess, 1, "m1")
    _add(sess, 2, "m2")
    bad = np.zeros((3, 3, 1), dtype=np.float32)
    t0 = sess.submit("m0", bad)
    t1 = sess.submit("m1", _feed(sess, "m1"))
    t2 = sess.submit("m2", bad)
    with pytest.raises(FlushError) as ei:
        sess.flush()
    assert set(ei.value.errors) == {"m0", "m2"}
    assert t1.done and t1.error is None
    assert isinstance(t0.error, ValueError)
    assert isinstance(t2.error, ValueError)
    assert sess.queue_depth == 0
    assert sess.stats()["models"]["m0"]["breaker"]["state"] == "closed"
    assert sess.stats()["models"]["m0"]["plan_failures"] == 0


# --------------------------------------------------------------------------
# circuit breaker: trip -> degraded oracle serving -> recovery
# --------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.parametrize("precision", ["int8", "float32"])
def test_transient_fault_retried_once(precision):
    sess = _session(precision, retry_backoff_ms=1.0)
    x = _feed(sess)
    with chaos.inject() as c:
        c.poison_plan("m0", times=1)
        t = sess.submit("m0", x)
        _check_output(sess, "m0", t.result(), x)
    st = sess.stats()["models"]["m0"]
    assert st["retries"] == 1 and st["plan_failures"] == 0
    assert st["breaker"]["state"] == "closed"


@pytest.mark.chaos
@pytest.mark.parametrize("precision", ["int8", "float32"])
def test_breaker_trips_then_serves_oracle_then_recovers(precision):
    """The ladder on both precisions: a tripped float32 model recovers
    through the probe too (its verify() holds the plan to the
    interpreter within the float tolerance, not bit for bit)."""
    sess = _session(precision, breaker_threshold=2, breaker_cooldown_s=0.1,
                    retry_backoff_ms=1.0)
    x = _feed(sess)
    with chaos.inject() as c:
        for _ in range(2):
            c.poison_plan("m0", times=2)
            t = sess.submit("m0", x)
            with pytest.raises(chaos.ChaosError):
                t.result()
        st = sess.stats()["models"]["m0"]
        assert st["breaker"]["state"] == "open"
        assert st["breaker_trips"] == 1 and st["plan_failures"] == 2
        c.poison_plan("m0", times=1)
        t = sess.submit("m0", x)
        _check_output(sess, "m0", t.result(), x)
        assert sess.stats()["models"]["m0"]["degraded_requests"] >= 1
        assert _wait_for(lambda: sess.stats()["models"]["m0"]
                         ["failed_recoveries"] >= 1)
        st = sess.stats()["models"]["m0"]
        assert st["failed_recoveries"] == 1
        assert st["breaker"]["state"] == "open"
    assert _wait_for(lambda: sess.stats()["models"]["m0"]["breaker"]
                     ["state"] == "closed")
    st = sess.stats()["models"]["m0"]
    assert st["recoveries"] == 1
    assert sess["m0"].plan_cache_info()["builds"] >= 1
    t = sess.submit("m0", x)
    _check_output(sess, "m0", t.result(), x)
    st = sess.stats()["models"]["m0"]
    assert st["latency"]["count"] > 0 and st["latency"]["p99_ms"] > 0


@pytest.mark.chaos
@pytest.mark.parametrize("precision", ["int8", "float32"])
def test_open_breaker_of_a_cuda_model_fails_fast_off_the_host(
        precision, monkeypatch):
    """A CUDA model's open breaker fails its batch fast with
    ``BreakerOpen`` and a retry hint, and never serves it from the host
    interpreter (the model's device is set to CUDA once the breaker is
    open: the branch reads only the device)."""
    sess = _session(precision, breaker_threshold=1, breaker_cooldown_s=60.0,
                    retry_backoff_ms=1.0)
    x = _feed(sess)
    try:
        with chaos.inject() as c:
            c.poison_plan("m0", times=2)
            with pytest.raises(chaos.ChaosError):
                sess.submit("m0", x).result()
        assert sess.stats()["models"]["m0"]["breaker"]["state"] == "open"

        def host_rung(*a, **k):
            raise AssertionError("a CUDA model was served from the host")

        monkeypatch.setattr(sess, "_degraded_run", host_rung)
        monkeypatch.setattr(sess["m0"], "device", torch.device("cuda"))
        with pytest.raises(api.BreakerOpen) as e:
            sess.submit("m0", x).result()
        assert 0 < e.value.retry_after_ms <= 60e3
        assert isinstance(e.value, api.ServingError)
        st = sess.stats()["models"]["m0"]
        assert st["breaker_rejects"] == 1 and st["degraded_requests"] == 0
        assert st["engine"] == "none" and st["breaker"]["state"] == "open"
        assert 'repro_breaker_rejects_total{model="m0"} 1' in sess.metrics()
    finally:
        sess.close()


def test_breaker_retry_hint_counts_down_the_cooldown():
    br = CircuitBreaker(threshold=1, cooldown_s=2.0)
    assert br.record_failure(now=100.0)
    assert br.retry_after_ms(now=100.5) == pytest.approx(1500.0)
    assert br.retry_after_ms(now=103.0) == 1.0     # the probe's turn


@pytest.mark.chaos
def test_output_corruption_is_keyed_by_model():
    """``corrupt_output(model)`` perturbs that model's next batch in any
    session, one element, and leaves every other model's alone."""
    sess = _session("int8")
    try:
        _add(sess, 1, "m1")
        x0, x1 = _feed(sess), _feed(sess, "m1")
        clean = sess.run_many("m0", [x0])[0]
        with chaos.inject() as c:
            c.corrupt_output("m0", times=1)
            _check_output(sess, "m1", sess.submit("m1", x1).result(), x1)
            bad = sess.submit("m0", x0).result()
            again = sess.submit("m0", x0).result()
            assert c.stats()["output_flips"] == 1
        diff = sum(int((bad[k] != clean[k]).sum()) for k in clean)
        assert diff == 1
        assert all(torch.equal(again[k], clean[k]) for k in clean)
    finally:
        sess.close()


@pytest.mark.chaos
def test_corrupt_artifact_takes_recompile_path(tmp_path):
    program_cache_configure(disk_dir=str(tmp_path))
    def compile5():                      # a fresh graph: PTQ annotates it
        g, w = _graph(5)
        return api.compile(g, weights=w, precision="int8", device="cpu")
    m = compile5()
    program_cache_clear()                # memory tier gone; disk stays
    with chaos.inject() as c:
        c.corrupt_artifacts(times=1)
        m2 = compile5()
    assert c.injected["artifact_faults"] == 1
    assert program_cache_info()["disk_rejects"] >= 1
    x = _inputs(m.graph, 1, 0)[0]
    got, want = m2(x), m(x, engine="interp")
    for k in want:
        err = float((got[k] - want[k]).abs().max())
        assert err <= m.semantics.plan_parity_tol(k)


# --------------------------------------------------------------------------
# worker pool
# --------------------------------------------------------------------------


@pytest.mark.chaos
def test_pool_serves_and_close_fails_leftovers():
    sess = _session(workers=2, linger_ms=1.0)
    x = _feed(sess)
    ts = [sess.submit("m0", x) for _ in range(8)]
    for t in ts:
        _check_output(sess, "m0", t.result(timeout=30), x)
    st = sess.stats()
    assert st["pool"]["dispatched_requests"] >= 8
    assert all(h["alive"] for h in st["workers"].values())
    assert all(h["stream"] is None for h in st["workers"].values())
    sess.close()
    with pytest.raises(Exception):
        sess.submit("m0", x)


@pytest.mark.chaos
def test_pool_recycles_stalled_worker_zero_ticket_loss():
    sess = _session(workers=2, heartbeat_timeout_s=0.15, linger_ms=1.0)
    with chaos.inject() as c:
        c.stall_worker(0, seconds=1.2)
        c.stall_worker(1, seconds=1.2)
        ts = [sess.submit("m0", _feed(sess, seed=i)) for i in range(10)]
        outs = [t.result(timeout=30) for t in ts]
    assert all(o is not None for o in outs)
    st = sess.stats()["pool"]
    assert st["recycled_workers"] >= 1
    assert st["redispatched_batches"] >= 1
    assert len(sess.stats()["workers"]) > 2
    sess.close()


@pytest.mark.chaos
def test_pool_deadline_auto_flush_is_latency_bounded():
    """The deadline submission is dispatched by the deadline-driven
    auto-flush, not the 500 ms linger: its queue wait (submit -> the
    batch's start, the session's own ``repro_queue_wait_ms`` record) stays
    under 0.4 s.  The bound is held on the queue wait, which the pool
    controls; the batch's CPU service and the oracle check behind it are
    not part of the flush, and on a host loaded by the suite's other
    workers they alone can take longer than the flush.  The breakdown is
    in the message."""
    sess = _session(workers=1, linger_ms=500.0)
    x = _feed(sess)
    sess.run("m0", x)                       # lower + arena before timing
    t0 = time.monotonic()
    t = sess.submit("m0", x, deadline_ms=100.0)
    out = t.result(timeout=10)
    result_s = time.monotonic() - t0
    _check_output(sess, "m0", out, x)
    snap = sess.registry.snapshot()
    wait = snap["repro_queue_wait_ms"]["model=m0"]
    service = snap["repro_batch_service_ms"]["model=m0"]
    assert wait["count"] == 1
    assert wait["max_ms"] < 400.0, (         # NOT the 500 ms linger
        f"queue wait {wait['max_ms']:.1f} ms, batch service "
        f"{service['max_ms']:.1f} ms, submit to result "
        f"{result_s * 1e3:.1f} ms")
    sess.close()


@pytest.mark.chaos
def test_deadline_dispatches_at_once_until_the_batch_time_is_known():
    """Until the model has served ``MIN_EST_SAMPLES`` pool batches the
    pool knows no batch time to subtract from a deadline, and a deadline
    submission dispatches at once: with a 1 s deadline its queue wait is
    the wake-up (the old reservation of ``DEFAULT_EST_MS`` held it ~995
    ms); once the batch time is known, the auto-flush holds the batch
    until the deadline minus its p99 again, and no later: its queue wait
    stays under the 1 s deadline.  The linger (5 s) never decides.  The
    reservation holds the pool's wake-up lateness as well as the batch
    time, so a late wake-up on a loaded machine serves the ticket
    rather than expiring it."""
    sess = _session(workers=1, linger_ms=5000.0)
    x = _feed(sess)
    sess.run("m0", x)                       # lower + arena before timing
    pool = sess._pool
    t = sess.submit("m0", x, deadline_ms=1000.0)
    t.result(timeout=10)
    wait = sess.registry.snapshot()["repro_queue_wait_ms"]["model=m0"]
    assert wait["count"] == 1 and wait["max_ms"] < 500.0, wait
    while pool._batch_ms.labels(model="m0").count < pool.MIN_EST_SAMPLES:
        sess.submit("m0", x, deadline_ms=1000.0).result(timeout=10)
    est = pool._dispatch_est_ms("m0")
    t0 = time.monotonic()
    held = sess.submit("m0", x, deadline_ms=1000.0)
    out = held.result(timeout=10)
    waited = time.monotonic() - t0
    last = sess.registry.snapshot()["repro_queue_wait_ms"]["model=m0"]
    assert held.error is None and out is not None          # served
    assert pool.counters["deadline_misses"] == 0, pool.counters
    assert pool._wake_slack_ms() >= pool.WAKE_FLOOR_MS
    assert est < 500.0 and waited > 0.4, (est, waited)
    assert last["max_ms"] < 1000.0, (est, waited, last)   # the deadline
    sess.close()


@pytest.mark.chaos
def test_wake_lateness_leaves_out_a_batch_that_waited_for_a_busy_worker():
    """``repro_pool_wake_late_ms`` holds how late an idle worker wakes for
    the due time its wait was timed to: the host's scheduling delay,
    which deadlines reserve and heartbeats are allowed.  A batch that
    comes due while the only worker runs a slow batch (0.6 s) waits for
    the worker, which is queueing: no sample holds that wait."""
    sess = _session(workers=1, linger_ms=1.0)
    x = _feed(sess)
    sess.run("m0", x)                       # lower + arena before timing
    steps = sess["m0"].lower()[0]

    def slow(run):
        def step(bufs, n):
            time.sleep(0.6 / len(steps))
            return run(bufs, n)
        return step

    for st in steps:
        st.run = slow(st.run)
    pool = sess._pool
    first = sess.submit("m0", x)
    while pool.counters["dispatched_batches"] < 1:
        time.sleep(0.005)
    t0 = time.monotonic()
    second = sess.submit("m0", _feed(sess, seed=1))
    assert first.result(timeout=30) is not None
    assert second.result(timeout=30) is not None
    waited_ms = (time.monotonic() - t0) * 1e3
    late = pool._wake_late_ms.labels()
    assert pool.counters["dispatched_batches"] == 2, pool.counters
    assert waited_ms > 600.0 and late.max < 300.0, (waited_ms, late.count,
                                                    late.max)
    sess.close()


@pytest.mark.chaos
def test_slow_batch_that_progresses_is_not_recycled():
    """A batch several heartbeat timeouts long whose plan steps keep
    moving (each step of a slow stub model sleeps) beats from its
    progress: no worker is recycled and the tickets are served.  A
    stall before the batch, with no progress, still recycles
    (``test_pool_recycles_stalled_worker_zero_ticket_loss``)."""
    sess = _session(workers=2, heartbeat_timeout_s=0.3, linger_ms=1.0)
    model = sess["m0"]
    steps = model.lower()[0]

    def slow(run):
        def step(bufs, n):
            time.sleep(1.2 / len(steps))
            return run(bufs, n)
        return step

    for st in steps:
        st.run = slow(st.run)
    x = _feed(sess)
    t0 = time.monotonic()
    ts = [sess.submit("m0", _feed(sess, seed=i)) for i in range(6)]
    outs = [t.result(timeout=30) for t in ts]
    assert time.monotonic() - t0 > 1.2       # slower than 4 timeouts
    assert all(o is not None for o in outs)
    st = sess.stats()["pool"]
    assert st["recycled_workers"] == 0, sess._pool.recycle_log
    assert st["redispatched_batches"] == 0
    _check_output(sess, "m0", sess.run("m0", x), x)
    sess.close()


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_ticket_terminates_under_random_faults(seed):
    rng = np.random.default_rng(seed)
    sess = _session(workers=2, max_queue=32, heartbeat_timeout_s=0.15,
                    linger_ms=1.0, breaker_threshold=2,
                    breaker_cooldown_s=0.1, retry_backoff_ms=1.0)
    _add(sess, 1, "m1")
    names = ["m0", "m1"]
    tickets, shed = [], 0
    with chaos.inject() as c:
        for step in range(60):
            r = rng.random()
            if r < 0.08:
                c.poison_plan(str(rng.choice(names)),
                              times=int(rng.integers(1, 3)))
            elif r < 0.12:
                c.stall_worker(int(rng.integers(0, 6)),
                               seconds=float(rng.uniform(0.2, 0.6)))
            elif r < 0.15:
                c.skew_clock(float(rng.uniform(0.0, 0.05)))
            name = str(rng.choice(names))
            deadline = float(rng.uniform(5, 500)) \
                if rng.random() < 0.4 else None
            try:
                tickets.append(sess.submit(
                    name, _feed(sess, name, seed=step),
                    deadline_ms=deadline))
            except Overloaded:
                shed += 1
            if rng.random() < 0.2:
                time.sleep(0.01)
        for t in tickets:
            try:
                t.result(timeout=30)
            except (DeadlineExceeded, WorkerLost, chaos.ChaosError):
                pass
        assert all(t.done for t in tickets)
    assert len(tickets) + shed == 60
    sess.close()
    st = sess.stats()
    served = sum(m["latency"]["count"] for m in st["models"].values()
                 if "latency" in m)
    failed = sum(1 for t in tickets if t.error is not None)
    assert served + failed >= len(tickets)


@pytest.mark.chaos
def test_sync_session_random_faults_single_thread():
    rng = np.random.default_rng(7)
    sess = _session(max_queue=16, breaker_threshold=2,
                    breaker_cooldown_s=0.05, retry_backoff_ms=1.0)
    x = _feed(sess)
    tickets = []
    with chaos.inject() as c:
        for step in range(40):
            if rng.random() < 0.15:
                c.poison_plan("m0", times=int(rng.integers(1, 3)))
            if rng.random() < 0.1:
                c.skew_clock(float(rng.uniform(0, 0.02)))
            try:
                tickets.append(sess.submit(
                    "m0", x, deadline_ms=float(rng.uniform(5, 200))
                    if rng.random() < 0.5 else None))
            except Overloaded:
                pass
            if rng.random() < 0.3:
                try:
                    sess.flush("m0")
                except FlushError:
                    pass
        try:
            sess.flush()
        except FlushError:
            pass
    assert all(t.done for t in tickets)
    assert sess.queue_depth == 0


@pytest.mark.chaos
def test_concurrent_submitters_one_pool():
    sess = _session(workers=2, max_queue=128, linger_ms=1.0)
    x = _feed(sess)
    want = sess["m0"](x, engine="interp")
    errs, done = [], []
    lock = threading.Lock()

    def client(n):
        for _ in range(n):
            try:
                out = sess.submit("m0", x).result(timeout=30)
                for k in want:
                    assert float((out[k] - want[k]).abs().max()) <= \
                        sess["m0"].semantics.plan_parity_tol(k)
                with lock:
                    done.append(1)
            except Overloaded:
                pass
            except Exception as e:       # pragma: no cover - diagnostics
                with lock:
                    errs.append(e)

    threads = [threading.Thread(target=client, args=(10,))
               for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, errs
    assert len(done) > 0
    sess.close()


# --------------------------------------------------------------------------
# EDF dispatch + priority classes (queue unit tests, workers=0)
# --------------------------------------------------------------------------


def test_edf_pop_order_within_model():
    pool = ServerPool(lambda name, entries: None, workers=0,
                      max_batch=4, linger_ms=0.0)
    try:
        now = chaos.now()
        for label, dl in (("A", now + 200.0), ("B", now + 50.0),
                          ("C", None), ("D", now + 100.0)):
            pool.submit("m0", label, Ticket(None, "m0", dl))
        with pool._cv:
            claim, _ = pool._claim_locked(chaos.now())
        name, entries = claim
        assert name == "m0"
        assert [feed for feed, _ in entries] == ["B", "D", "A", "C"]
    finally:
        pool.close()


def test_priority_class_dispatch_across_models():
    pool = ServerPool(lambda name, entries: None, workers=0,
                      max_batch=4, linger_ms=0.0)
    try:
        pool.set_priority("hi", 1)
        for i in range(2):
            pool.submit("lo", f"lo{i}", Ticket(None, "lo"))
        for i in range(2):
            pool.submit("hi", f"hi{i}", Ticket(None, "hi"))
        time.sleep(0.002)
        with pool._cv:
            first, _ = pool._claim_locked(chaos.now())
            second, _ = pool._claim_locked(chaos.now())
        assert first is not None and first[0] == "hi"
        assert second is not None and second[0] == "lo"
    finally:
        pool.close()


def test_pool_saturation_sheds_low_priority_first():
    pool = ServerPool(lambda name, entries: None, workers=0,
                      max_batch=4, max_queue=8, max_queue_total=3,
                      linger_ms=1e6)
    try:
        pool.set_priority("hi", 1)
        lo = [Ticket(None, "lo") for _ in range(3)]
        for i, t in enumerate(lo):
            pool.submit("lo", f"lo{i}", t)
        t_hi = Ticket(None, "hi")
        pool.submit("hi", "hi0", t_hi)
        assert pool.counters["priority_evictions"] == 1
        assert sum(1 for t in lo if isinstance(t.error, Overloaded)) == 1
        assert not t_hi.done
        with pytest.raises(Overloaded):
            pool.submit("lo", "lox", Ticket(None, "lo"))
        assert pool.queue_depth("hi") == 1
    finally:
        pool.close()


# --------------------------------------------------------------------------
# client retries and cancellation
# --------------------------------------------------------------------------


def test_submit_retries_absorb_shed_until_queue_drains():
    sess = _session(max_queue=2, max_batch=8)
    try:
        x = _feed(sess)
        for _ in range(2):
            sess.submit("m0", x)
        with pytest.raises(Overloaded):
            sess.submit("m0", x)
        th = threading.Thread(
            target=lambda: (time.sleep(0.01), sess.flush("m0")))
        th.start()
        t = sess.submit("m0", x, retries=12, retry_cap_ms=100.0)
        th.join()
        _check_output(sess, "m0", t.result(timeout=30), x)
        assert sess.stats()["models"]["m0"]["submit_retries"] >= 1
    finally:
        sess.close()


def test_submit_retries_respect_deadline():
    sess = _session(max_queue=1, max_batch=8)
    try:
        x = _feed(sess)
        sess.submit("m0", x)
        t0 = time.monotonic()
        with pytest.raises(Overloaded):
            sess.submit("m0", x, deadline_ms=80.0, retries=50,
                        retry_cap_ms=1000.0)
        assert (time.monotonic() - t0) < 1.0
    finally:
        sess.close()


def test_cancel_queued_drops_from_edf_queue():
    sess = _session(workers=1, linger_ms=500.0)
    try:
        x = _feed(sess)
        t = sess.submit("m0", x)
        assert sess._pool.queue_depth("m0") == 1
        assert t.cancel() is True
        assert sess._pool.queue_depth("m0") == 0
        with pytest.raises(api.Cancelled):
            t.result(timeout=5)
        assert t.cancel() is False
        t2 = sess.submit("m0", x)
        _check_output(sess, "m0", t2.result(timeout=30), x)
        assert sess.stats()["models"]["m0"]["cancelled"] == 1
    finally:
        sess.close()


@pytest.mark.chaos
def test_cancel_in_flight_first_settlement_wins():
    sess = _session(workers=1, linger_ms=1.0, heartbeat_timeout_s=30.0)
    try:
        x = _feed(sess)
        with chaos.inject() as c:
            c.stall_worker(0, seconds=0.4)
            t = sess.submit("m0", x)
            time.sleep(0.1)
            won = t.cancel()
        if won:
            with pytest.raises(api.Cancelled):
                t.result(timeout=30)
            assert sess.stats()["models"]["m0"]["cancelled"] == 1
        else:
            _check_output(sess, "m0", t.result(timeout=30), x)
        t2 = sess.submit("m0", x)
        _check_output(sess, "m0", t2.result(timeout=30), x)
    finally:
        sess.close()


# --------------------------------------------------------------------------
# the Session surface (tests/test_api.py) and what is not ported
# --------------------------------------------------------------------------


def test_session_multi_model_precisions(tmp_path):
    sess = api.Session(cache_dir=str(tmp_path / "cache"), device="cpu")
    f = sess.add(_tiny_graph(TGraphBuilder, name="sfloat"), name="tiny_f32")
    q = sess.add(_tiny_graph(TGraphBuilder, name="squant"), name="tiny_int8",
                 precision="int8", calib_samples=2)
    assert f.precision == "float32" and q.precision == "int8"
    assert set(sess.models()) == {"tiny_f32", "tiny_int8"}
    x = _input(f.graph)
    out = sess.run("tiny_f32", x)
    assert set(out) == {t.name for t in f.graph.outputs}
    assert all(v.device.type == "cpu" for v in out.values())
    sess.run("tiny_int8", x)
    st = sess.stats()
    assert st["models"]["tiny_f32"]["requests"] == 1
    assert st["models"]["tiny_int8"]["precision"] == "int8"
    assert st["models"]["tiny_f32"]["compiles"]["solved"] == 1
    sess.add(_tiny_graph(TGraphBuilder, name="sfloat"), name="tiny_f32")
    assert sess.stats()["models"]["tiny_f32"]["compiles"]["memory"] == 1
    assert "Session" in sess.report()
    with pytest.raises(KeyError):
        sess.run("nope", x)


def test_session_load_artifact_and_warmup(tmp_path):
    m = api.compile(_tiny_graph(TGraphBuilder), cache=False, device="cpu")
    p = m.save(str(tmp_path / "m.rpa"))
    sess = api.Session(device="cpu")
    sess.load(p, name="from_disk")
    sess.warmup("from_disk")
    x = _input(m.graph)
    name = m.graph.outputs[0].name
    assert torch.equal(sess.run("from_disk", x)[name], m(x)[name])
    assert sess.stats()["models"]["from_disk"]["compiles"]["artifact"] == 1


def test_session_registers_a_compiled_model_as_it_is():
    g, w = _graph(0)
    m = api.compile(g, weights=w, precision="int8", device="cpu")
    sess = api.Session(device="cpu", workers=1)
    try:
        assert sess.add(m, name="m0") is m
        x = _feed(sess)
        _check_output(sess, "m0", sess.submit("m0", x).result(timeout=30),
                      x)
        assert sess.stats()["models"]["m0"]["compiles"]["memory"] == 0
    finally:
        sess.close()


def test_session_run_many_returns_host_rows():
    sess = _session(max_batch=3)
    xs = _inputs(sess["m0"].graph, 7, 1)
    outs = sess.run_many("m0", xs)
    assert len(outs) == 7
    for x, out in zip(xs, outs):
        _check_output(sess, "m0", out, x)
    st = sess.stats()["models"]["m0"]
    assert (st["batches"], st["max_batch_seen"]) == (3, 3)


def test_process_pools_and_fleets_name_item_10():
    """Item 10 is done: a process pool and a fleet are built (their
    serving is held in ``tests/test_torch_procpool.py`` and
    ``tests/test_torch_fleet.py``); an unknown pool mode still raises."""
    from repro_torch.runtime.fleet import Fleet
    from repro_torch.runtime.procpool import ProcPool
    sess = api.Session(device="cpu", workers=("process", 1))
    try:
        assert isinstance(sess._pool, ProcPool)
        assert sess._pool.mode == "process"
    finally:
        sess.close()
    fleet = api.Session.fleet(replicas=2, workers=1, device="cpu")
    try:
        assert isinstance(fleet, Fleet)
        assert fleet.replicas() == {0: "live", 1: "live"}
        assert [r.session.tag for r in fleet._replicas.values()] == \
            ["r0", "r1"]
    finally:
        fleet.close()
    with pytest.raises(ValueError):
        api.Session(device="cpu", workers=("fiber", 2))


def test_session_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Session()


# --------------------------------------------------------------------------
# observability (tests/test_obs.py)
# --------------------------------------------------------------------------


def test_session_metrics_exposition_covers_runtime():
    with api.Session(max_batch=4, device="cpu") as sess:
        _add(sess, 0, "m0")
        x = _inputs(sess["m0"].graph, 1)[0]
        tickets = [sess.submit("m0", x) for _ in range(3)]
        sess.flush("m0")
        assert all(t.done and t.error is None for t in tickets)
        text = sess.metrics()
    assert "# TYPE repro_request_latency_ms summary" in text
    assert 'repro_request_latency_ms_count{model="m0"} 3' in text
    assert 'repro_requests_total{model="m0"} 3' in text
    assert "# TYPE repro_shed_total counter" in text
    assert 'repro_breaker_state{model="m0"} 0' in text
    assert "repro_program_cache_total" in text
    assert 'repro_modeled_latency_ms{model="m0"}' in text
    assert "repro_queue_depth 0" in text
    assert sess.stats()["models"]["m0"]["latency"]["count"] == 3


@pytest.mark.chaos
def test_pooled_round_trip_trace_and_metrics():
    tr = trace.enable()
    sess = api.Session(max_batch=4, workers=2, max_queue=64, linger_ms=1.0,
                       device="cpu")
    _add(sess, 0, "m0")
    x = _inputs(sess["m0"].graph, 1)[0]
    tickets = [sess.submit("m0", x) for _ in range(12)]
    for t in tickets:
        t.result(timeout=30)
    metrics_text = sess.metrics()
    sess.close()
    trace.disable()

    doc = tr.chrome_trace()
    assert validate_chrome_trace(doc) == []
    evs = doc["traceEvents"]
    names = {d.get("name") for d in evs}
    for want in ("submit", "queue_wait", "batch", "worker", "serve"):
        assert want in names, f"missing {want!r} span"
    assert any(d.get("cat") == "plan" for d in evs)

    def ids(name):
        return {d["args"]["trace_id"]: d["tid"] for d in evs
                if d.get("name") == name and d.get("ph") == "X"
                and "trace_id" in d.get("args", {})}

    submits, serves = ids("submit"), ids("serve")
    crossed = [i for i in submits.keys() & serves.keys()
               if submits[i] != serves[i]]
    assert crossed, "no request crossed submitter -> worker thread"
    flow_ids = {d["id"] for d in evs if d.get("cat") == "flow"}
    assert flow_ids & set(crossed), "flow arrows missing for the hop"
    assert "repro_pool_batch_ms" in metrics_text
    assert "repro_worker_alive" in metrics_text
    assert "repro_pool_workers 2" in metrics_text


# --------------------------------------------------------------------------
# the port's Session against the reference's on the same requests
# --------------------------------------------------------------------------


def _pair(seed, precision, **kw):
    gj, bj = random_graph(seed)
    gt, wt = _to_port(gj, bj._weights)   # before PTQ annotates gj
    sj = japi.Session(**kw)
    sj.add((gj, bj), name="m", precision=precision)
    st = api.Session(device="cpu", **kw)
    st.add(gt, weights=wt, name="m", precision=precision)
    return sj, st


def _same_outputs(precision, got, want):
    for k, w in want.items():
        g = got[k].numpy()
        if precision == "int8":
            assert np.array_equal(g, w), k
        else:
            assert float(np.abs(g - w).max()) <= float_plan_tol(w), k


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("precision", ["int8", "float32"])
def test_sync_session_matches_reference(seed, precision):
    """Synchronous mode: the same 11 submissions, flushed at the same
    points, give the reference's outputs and counters."""
    sj, st = _pair(seed, precision, max_batch=4)
    xs = _inputs(st["m"].graph, 11, seed)
    tj, tt = [], []
    for i, x in enumerate(xs):
        tj.append(sj.submit("m", x))
        tt.append(st.submit("m", x))
        if i in (2, 9):
            assert sj.flush("m") == st.flush("m")
    assert sj.flush() == st.flush()
    for a, b in zip(tt, tj):
        _same_outputs(precision, a.result(), b.result())
    for key in ("requests", "batches", "batched_requests", "max_batch_seen",
                "shed", "deadline_misses", "retries"):
        assert st.stats()["models"]["m"][key] == \
            sj.stats()["models"]["m"][key], key
    _same_outputs(precision, st.run("m", xs[0]), sj.run("m", xs[0]))


@pytest.mark.parametrize("precision", ["int8", "float32"])
def test_pooled_session_matches_reference(precision):
    sj, st = _pair(2, precision, max_batch=4, workers=2, linger_ms=1.0)
    try:
        xs = _inputs(st["m"].graph, 12, 5)
        tj = [sj.submit("m", x) for x in xs]
        tt = [st.submit("m", x) for x in xs]
        for a, b in zip(tt, tj):
            _same_outputs(precision, a.result(timeout=30),
                          b.result(timeout=30))
        assert st.stats()["models"]["m"]["requests"] == 12
    finally:
        sj.close()
        st.close()


# --------------------------------------------------------------------------
# thread safety: the plan cache and the kernel build
# --------------------------------------------------------------------------


def _race(n, fn):
    """Run ``fn(i)`` on ``n`` threads released together."""
    barrier = threading.Barrier(n)
    errs = []

    def body(i):
        barrier.wait()
        try:
            fn(i)
        except Exception as e:           # pragma: no cover - diagnostics
            errs.append(e)
    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, errs


def test_plan_for_lowers_once_across_threads(monkeypatch):
    import repro_torch.api.compiled as compiled
    g, w = _graph(1)
    m = api.compile(g, weights=w, precision="int8", device="cpu")
    calls = []
    real = compiled.lower_steps

    def counting(*a, **kw):
        calls.append(1)
        time.sleep(0.05)                 # widen the race window
        return real(*a, **kw)
    monkeypatch.setattr(compiled, "lower_steps", counting)
    plans = {}
    _race(8, lambda i: plans.__setitem__(i, m.plan_for(4, owner=i % 4)))
    assert len(calls) == 1
    assert len({id(p) for p in plans.values()}) == 4     # one per owner
    assert all(p.steps is plans[0].steps for p in plans.values())
    info = m.plan_cache_info()
    assert info["builds"] == 4 and info["hits"] == 4

    m.invalidate_plans()
    assert m.plan_cache_info()["plans"] == [] and not len(m._plan_consts)
    m.plan_for(1)
    assert len(calls) == 2 and m.plan_cache_info()["consts_computed"] > 0


def test_kernel_library_builds_and_loads_once_across_threads(
        monkeypatch, tmp_path):
    so = tmp_path / "neutron_matmul-test.so"
    builds, loads = [], []

    def build_all():
        builds.append(1)
        time.sleep(0.05)
        so.write_bytes(b"")
        return 0.05

    class Lib:
        def __init__(self, path):
            loads.append(path)
            self.rt_error_string = lambda *a: b""

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_library_path", lambda name: so)
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    libs = []
    _race(8, lambda i: libs.append(_build._library("neutron_matmul")))
    assert len(builds) == 1 and loads == [str(so)]
    assert all(lib is libs[0] for lib in libs)

