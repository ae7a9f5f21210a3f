"""``repro_torch.runtime.fleet.Fleet`` on the CPU (ROADMAP item 10), against
the JAX package's ``repro.runtime.fleet.Fleet``.

The 11 tests of ``tests/test_fleet.py`` on the port's ``Fleet``, with
``device="cpu"`` replicas (thread pools; the plans take K1's plain
version).  Both packages' fleets load the same ``.rpa`` artifacts (int8
random graphs compiled by the reference), and every output the port's
fleet serves is held to the interpreter within ``plan_parity_tol`` and
to the reference Fleet's output for the same request: the stored ints
equal (``array_equal`` of the decoded floats).  The fleet contract: every
fleet ticket terminates exactly once, under replica death, hedging,
cancellation, artifact swaps and silently corrupting replicas, and the
corruption is caught (audited) and contained (quarantine, recycle).
"""
import random
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
from repro_torch.api import (Cancelled, DeadlineExceeded, Overloaded,
                             UpdateRejected, WorkerLost)
from repro_torch.core import (program_cache_clear, program_cache_configure,
                              program_cache_info)
from repro_torch.runtime.fleet import Fleet

from test_execplan import _inputs, random_graph


@pytest.fixture(autouse=True)
def _isolated_caches():
    saved = program_cache_info(), j_cache_info()
    for clear, configure in ((program_cache_clear, program_cache_configure),
                             (j_cache_clear, j_cache_configure)):
        clear()
        configure(max_entries=64, max_bytes=None, disk_dir=None)
    yield
    for (clear, configure), s in zip(
            ((program_cache_clear, program_cache_configure),
             (j_cache_clear, j_cache_configure)), saved):
        clear()
        configure(max_entries=s["max_entries"], max_bytes=s["max_bytes"],
                  disk_dir=s["disk_dir"])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """seed -> the ``.rpa`` of ``random_graph(seed)`` at int8, saved by
    the reference: both packages' fleets serve these files."""
    d = tmp_path_factory.mktemp("fleet_rpa")
    paths = {}
    for seed in (0, 1, 2):
        m = japi.compile(random_graph(seed), precision="int8", cache=False)
        paths[seed] = m.save(str(d / f"m{seed}.rpa"))
    return paths


class _Ref:
    """The reference Fleet on the same artifacts: the expected output of
    each (model, request), computed once through its ``submit``."""

    def __init__(self, artifacts, names):
        self.fleet = japi.Session.fleet(replicas=2, workers=1, max_batch=4,
                                        hedge=False)
        for name, seed in names.items():
            self.fleet.load(artifacts[seed], name=name)
        self._memo = {}

    def out(self, name, feed, key):
        if (name, key) not in self._memo:
            self._memo[(name, key)] = \
                self.fleet.submit(name, feed).result(timeout=60)
        return self._memo[(name, key)]

    def close(self):
        self.fleet.close()


@pytest.fixture
def ref(artifacts):
    r = _Ref(artifacts, {"m0": 0, "m1": 1})
    yield r
    r.close()


def _fleet(artifacts, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("workers", 1)
    kw.setdefault("max_batch", 4)
    fleet = api.Session.fleet(device="cpu", **kw)
    fleet.load(artifacts[0], name="m0")
    return fleet


def _feed(fleet, name="m0", seed=0):
    return _inputs(fleet._oracles[name].graph, 1, seed)[0]


def _check(fleet, name, out, feed, ref=None, key=None):
    """A served output: CPU tensors within the plan's parity tolerance of
    the port's interpreter and, given ``ref``, equal to the reference
    Fleet's output for the same request."""
    oracle = fleet._oracles[name]
    want = oracle(feed, engine="interp")
    for k, w in want.items():
        got = out[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        w = w.numpy()
        err = float(np.max(np.abs(got.numpy() - w)))
        assert err <= oracle.semantics.plan_parity_tol(k, w), \
            f"{name}/{k}: served output diverged from oracle by {err}"
    if ref is not None:
        for k, r in ref.out(name, feed, key).items():
            assert np.array_equal(out[k].numpy(), np.asarray(r)), \
                f"{name}/{k}: differs from the reference Fleet's output"


def _wait_all_live(fleet, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(s == "live" for s in fleet.replicas().values()):
            return True
        time.sleep(0.1)
    return False


# --------------------------------------------------------------------------
# construction / placement units
# --------------------------------------------------------------------------


def test_fleet_requires_worker_pools():
    with pytest.raises(ValueError, match="workers"):
        Fleet(replicas=2, workers=0, device="cpu")
    with pytest.raises(ValueError, match="replica"):
        Fleet(replicas=0, device="cpu")


@pytest.mark.chaos
def test_fleet_placement_and_unknown_model(artifacts, ref):
    fleet = _fleet(artifacts)
    try:
        assert fleet.placement() == {"m0": [0, 1]}
        fleet.load(artifacts[1], name="m1", replicas=[1])
        assert fleet.placement()["m1"] == [1]
        assert fleet.models() == ["m0", "m1"]
        with pytest.raises(KeyError, match="m9"):
            fleet.submit("m9", {})
        with pytest.raises(ValueError, match="unknown replica"):
            fleet.load(artifacts[2], name="m2", replicas=[7])
        x = _feed(fleet, "m1")
        _check(fleet, "m1", fleet.submit("m1", x).result(timeout=60), x,
               ref, 0)
    finally:
        fleet.close()


@pytest.mark.chaos
def test_fleet_serves_with_parity_and_balanced_routing(artifacts, ref):
    """Requests spread across replicas (health scores tie, served-count
    breaks ties) and every output matches the interpretive oracle and
    the reference Fleet."""
    fleet = _fleet(artifacts, hedge=False)
    try:
        feeds = [_feed(fleet, seed=i) for i in range(8)]
        ts = [fleet.submit("m0", f) for f in feeds]
        for i, (t, f) in enumerate(zip(ts, feeds)):
            _check(fleet, "m0", t.result(timeout=60), f, ref, i)
        assert fleet.flush(30)
        s = fleet.stats()
        assert s["completed"] == 8 and s["failed"] == 0
        served = [r["served"] for r in s["replicas"].values()]
        assert all(v > 0 for v in served), served
        assert "repro_fleet_requests_total" in fleet.metrics()
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# hedging
# --------------------------------------------------------------------------


@pytest.mark.chaos
def test_fleet_hedge_rescues_stalled_replica(artifacts, ref):
    """A request stuck behind a stalled worker is re-issued to the other
    replica after the hedge timeout; the hedge's result settles the
    ticket long before the stall clears.  The warm-up requests are not
    hedged: on a loaded host one of them takes longer than the 80 ms
    hedge timeout, and its hedge would spend the fleet's hedge budget (a
    tenth of the requests), so the stalled request would wait out the
    stall unhedged."""
    fleet = _fleet(artifacts, hedge_after_ms=80.0, heartbeat_timeout_s=60.0)
    try:
        x = _feed(fleet)
        for _ in range(4):                       # warm both replicas
            fleet.submit("m0", x, hedge=False).result(timeout=60)
        assert fleet.stats()["hedges"] == 0
        with chaos.inject() as c:
            c.stall_worker(0, seconds=3.0)       # one replica's worker
            t0 = time.monotonic()
            t = fleet.submit("m0", x)
            out = t.result(timeout=60)
            dt = time.monotonic() - t0
        _check(fleet, "m0", out, x, ref, 0)
        s = fleet.stats()
        assert s["hedges"] >= 1 and s["hedge_wins"] >= 1, s
        assert dt < 2.0, f"hedge did not rescue: {dt:.2f}s"
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# pool-level failover
# --------------------------------------------------------------------------


@pytest.mark.chaos
def test_fleet_replica_kill_zero_ticket_loss(artifacts, ref):
    """Killing a whole replica pool mid-burst loses no ticket: queued
    attempts fail over to the survivor with backoff, the dead replica
    recycles in the background and serves again."""
    fleet = _fleet(artifacts, hedge=False)
    try:
        feeds = [_feed(fleet, seed=i) for i in range(10)]
        with chaos.inject() as c:
            ts = [fleet.submit("m0", f) for f in feeds]
            c.kill_pool(0)
            for i, (t, f) in enumerate(zip(ts, feeds)):
                _check(fleet, "m0", t.result(timeout=60), f, ref, i)
            assert c.stats()["pool_kills"] == 1
        s = fleet.stats()
        assert s["pool_deaths"] == 1 and s["failed"] == 0
        assert _wait_all_live(fleet), fleet.replicas()
        assert fleet.stats()["recycles"] >= 1
        t = fleet.submit("m0", feeds[0])         # post-recycle health
        _check(fleet, "m0", t.result(timeout=60), feeds[0], ref, 0)
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# silent-corruption auditor
# --------------------------------------------------------------------------


@pytest.mark.chaos
def test_fleet_auditor_quarantines_corrupting_replica(artifacts, ref):
    """A replica that silently flips output bits (no error raised) is
    caught by the sampling auditor's interpreter re-execution,
    quarantined once its mismatch count crosses the threshold, and
    recycled back to honest service."""
    fleet = _fleet(artifacts, audit_fraction=1.0, audit_threshold=2,
                   hedge=False)
    try:
        x = _feed(fleet)
        with chaos.inject() as c:
            c.corrupt_output("m0", times=50, tag="r1")   # only replica 1
            ts = [fleet.submit("m0", x) for _ in range(12)]
            for t in ts:
                t.result(timeout=60)
            fleet.flush(30)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if fleet.stats()["quarantines"] >= 1:
                    break
                time.sleep(0.1)
        s = fleet.stats()
        assert s["audit_mismatch"] >= 2, s
        assert s["quarantines"] >= 1, s
        assert s["replicas"][1]["quarantines"] >= 1
        assert s["replicas"][0]["quarantines"] == 0      # honest one
        assert _wait_all_live(fleet), fleet.replicas()
        # recycled replica serves honestly again; audits come back clean
        before = fleet.stats()["audit_mismatch"]
        ts = [fleet.submit("m0", x) for _ in range(6)]
        for t in ts:
            _check(fleet, "m0", t.result(timeout=60), x, ref, 0)
        fleet.flush(30)
        time.sleep(1.0)                                  # auditor drains
        assert fleet.stats()["audit_mismatch"] == before
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# rolling artifact updates
# --------------------------------------------------------------------------


@pytest.mark.chaos
def test_fleet_rolling_update_and_canary_rollback(artifacts, ref, tmp_path):
    """update() swaps replicas one at a time behind a canary that
    shadow-verifies the new artifact against the interpretive oracle; a
    corrupted canary rejects the update with zero replicas swapped."""
    fleet = _fleet(artifacts, hedge=False)
    try:
        x = _feed(fleet)
        p = str(tmp_path / "m0.rpa")
        fleet._oracles["m0"].save(p)             # the port's own save
        assert fleet.update("m0", p) == 2
        assert fleet._specs["m0"]["kind"] == "load"
        t = fleet.submit("m0", x)
        _check(fleet, "m0", t.result(timeout=60), x, ref, 0)

        with chaos.inject() as c:
            c.corrupt_canary("m0", times=1)
            with pytest.raises(UpdateRejected, match="canary"):
                fleet.update("m0", p)
            assert c.stats()["canary_corruptions"] == 1
        s = fleet.stats()
        assert s["updates_ok"] == 1 and s["updates_rolled_back"] == 1
        assert all(st == "live" for st in fleet.replicas().values())
        t = fleet.submit("m0", x)                # old artifact serves on
        _check(fleet, "m0", t.result(timeout=60), x, ref, 0)
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# pin rebalancing
# --------------------------------------------------------------------------


@pytest.mark.chaos
def test_fleet_rebalance_rehomes_and_repins(artifacts, ref):
    """rebalance() re-homes models (heaviest traffic first) onto the
    least-loaded replicas; program-cache pins follow the move."""
    fleet = _fleet(artifacts, replicas=2, hedge=False)
    try:
        fleet.load(artifacts[1], name="m1", replicas=[0], pin=True)
        with fleet._cv:
            fleet._placement["m0"] = {0}
            fleet._specs["m0"]["pin"] = True
        fleet._replicas[0].session.pin("m0")
        for i in range(6):
            fleet.submit("m0", _feed(fleet, seed=i)).result(timeout=60)
        fleet.submit("m1", _feed(fleet, "m1")).result(timeout=60)
        moves = fleet.rebalance()
        # heaviest (m0) keeps r0; m1 moves to the now-less-loaded r1
        assert fleet.placement() == {"m0": [0], "m1": [1]}
        assert moves == {"m1": [1]}
        assert "m1" in fleet._replicas[1].session
        assert "m1" in fleet._replicas[1].session._pinned
        assert "m1" not in fleet._replicas[0].session._pinned
        x = _feed(fleet, "m1")
        _check(fleet, "m1", fleet.submit("m1", x).result(timeout=60), x,
               ref, 0)
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# cancellation through the fleet
# --------------------------------------------------------------------------


@pytest.mark.chaos
def test_fleet_cancel_settles_exactly_once(artifacts, ref):
    fleet = _fleet(artifacts, hedge=False)
    try:
        x = _feed(fleet)
        results = {"cancelled": 0, "served": 0}
        for _ in range(6):
            t = fleet.submit("m0", x)
            won = t.cancel()
            try:
                out = t.result(timeout=60)
                assert not won
                _check(fleet, "m0", out, x, ref, 0)
                results["served"] += 1
            except Cancelled:
                assert won
                results["cancelled"] += 1
        s = fleet.stats()
        assert s["cancelled"] == results["cancelled"]
        assert s["completed"] == results["served"]
        assert s["completed"] + s["cancelled"] == 6
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# property: randomized kills + hedges + cancels, exactly-once settlement
# --------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_random_faults_every_ticket_settles_once(artifacts, ref, seed):
    """A randomized schedule of replica kills, hedged requests and
    cancellations never loses or double-settles a ticket: every ticket
    terminates with a correct result or a typed error, and the fleet's
    settlement counters sum to the request count."""
    rng = random.Random(seed)
    fleet = _fleet(artifacts, hedge_after_ms=40.0, max_redispatch=10,
                   audit_fraction=0.2, backoff_cap_ms=50.0)
    try:
        feeds = [_feed(fleet, seed=i) for i in range(6)]
        n = 24
        with chaos.inject() as c:
            tickets = []
            for i in range(n):
                t = fleet.submit("m0", feeds[i % 6],
                                 deadline_ms=5000.0
                                 if rng.random() < 0.3 else None)
                tickets.append((t, i % 6))
                r = rng.random()
                if r < 0.10:
                    c.kill_pool(rng.randrange(2))
                elif r < 0.25:
                    t.cancel()
                time.sleep(rng.random() * 0.01)
            for t, fi in tickets:
                try:
                    out = t.result(timeout=120)
                    _check(fleet, "m0", out, feeds[fi], ref, fi)
                except (Cancelled, DeadlineExceeded, WorkerLost,
                        Overloaded, chaos.ChaosError):
                    pass          # typed terminations are all legal
        assert fleet.flush(60)
        s = fleet.stats()
        assert s["completed"] + s["failed"] + s["cancelled"] == n, s
        assert _wait_all_live(fleet, timeout=60), fleet.replicas()
        t = fleet.submit("m0", feeds[0])
        _check(fleet, "m0", t.result(timeout=60), feeds[0], ref, 0)
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# lifecycle
# --------------------------------------------------------------------------


@pytest.mark.chaos
def test_fleet_close_fails_inflight_with_typed_error(artifacts, ref):
    fleet = _fleet(artifacts, hedge=False)
    x = _feed(fleet)
    ts = [fleet.submit("m0", x) for _ in range(4)]
    fleet.close()
    for t in ts:
        assert t.done
        if t.error is not None:
            assert isinstance(t.error, WorkerLost)
        else:
            _check(fleet, "m0", t.result(), x, ref, 0)
    with pytest.raises(Exception):
        fleet.submit("m0", x)
    fleet.close()                                # idempotent
