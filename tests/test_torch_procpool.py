"""``repro_torch.runtime.procpool`` — the process worker pool — on the CPU
(ROADMAP item 10), against the JAX package's ``repro.runtime.procpool``.

* the ``rpa2`` CRC frames: built by both packages from the same header
  and arrays they are byte-equal, and each package unpacks the other's;
  a flipped blob raises ``FrameCorrupt``, a flipped header
  ``ProtocolError``; the chaos bit-flip hits only payload frames;
* ``Session(workers=("process", 2))`` on ``device="cpu"``: the stored
  ints of every request equal ``repro.api.Session(workers=("process",
  2))``'s on the same artifact, in batches of 1, 3, 8 and a ragged 5;
  the children are other processes, on the CPU, and none has JAX;
* the process and frame cases of ``tests/test_robust.py``: a worker
  killed (SIGKILL, SIGSEGV, the OOM exit) with its batch in flight, or a
  reply frame bit-flipped, loses no ticket, and a replacement child
  becomes ready;
* a child that cannot load a model reports it: ``add`` raises and
  ``worker_health()`` shows the error;
* :func:`procpool.device_context_lost`, which decides whether a batch's
  CUDA error poisoned its context (the child then exits as crashed).
"""
import os
import time

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.runtime.procpool as jprocpool
import repro_torch.api as api
import repro_torch.runtime.chaos as chaos
import repro_torch.runtime.procpool as procpool
from repro.core import program_cache_clear as j_cache_clear
from repro.core import program_cache_configure as j_cache_configure
from repro.core import program_cache_info as j_cache_info
from repro.runtime.serving import FrameCorrupt as JFrameCorrupt
from repro_torch.core import (program_cache_clear, program_cache_configure,
                              program_cache_info)
from repro_torch.runtime.serving import FrameCorrupt

from test_execplan import _inputs, random_graph
from test_torch_vision import _to_port


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


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs, so its children take
    one each: the suite runs files side by side, some of them
    timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _proc_session(n=2, **kw):
    """A CPU process-pool session serving the port's compile of
    ``random_graph(0)`` at int8 (spooled to an artifact for the
    children), as ``tests/test_robust.py``'s ``_proc_session``."""
    kw.setdefault("max_batch", 4)
    kw.setdefault("heartbeat_timeout_s", 2.0)
    sess = api.Session(workers=("process", n), device="cpu", **kw)
    gj, bj = random_graph(0)
    g, w = _to_port(gj, bj._weights)
    sess.add(g, weights=w, name="m0", precision="int8")
    return sess


def _feed(sess, name="m0", seed=0):
    return _inputs(sess[name].graph, 1, seed)[0]


def _check_output(sess, name, out, feed):
    want = sess[name](feed, engine="interp")
    for k, w in want.items():
        got = out[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        w = w.numpy()
        err = float(np.max(np.abs(got.numpy() - w)))
        assert err <= sess[name].semantics.plan_parity_tol(k, w), \
            f"{name}/{k}: served output diverged from oracle by {err}"


def _ready_children(sess):
    return [h for h in sess._pool.worker_health().values()
            if h.get("ready") and not h["abandoned"]]


# --------------------------------------------------------------------------
# frames: byte-equal across packages, CRC
# --------------------------------------------------------------------------


FRAMES = {
    "hb": ({"type": "hb", "seq": 3}, None),
    "res": ({"type": "res", "req": 7, "seq": 2},
            {"y": np.arange(12, dtype=np.float32).reshape(3, 4),
             "q": np.arange(-6, 6, dtype=np.int8).reshape(2, 6),
             "s": np.float32(2.5), "e": np.zeros((0, 3), np.float32)}),
    "strided": ({"type": "res", "req": 1},
                {"t": np.arange(24, dtype=np.int32).reshape(4, 6)[:, ::2]}),
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_frames_are_byte_equal_across_packages(case):
    header, arrays = FRAMES[case]
    ours = bytes(procpool.pack_frame(header, arrays))
    theirs = bytes(jprocpool.pack_frame(header, arrays))
    assert ours == theirs
    for unpack, buf in ((procpool.unpack_frame, theirs),
                        (jprocpool.unpack_frame, ours)):
        h, out = unpack(buf)
        assert h == {k: v for k, v in header.items()}
        for k, v in (arrays or {}).items():
            assert out[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(out[k], v)


def test_run_frames_are_byte_equal_across_packages():
    rng = np.random.default_rng(0)
    feeds = [{"x": rng.normal(size=(4, 4, 3)).astype(np.float32),
              "z": np.full((2,), i, np.int64)} for i in range(5)]
    header = {"type": "run", "req": 9, "model": "m", "n": 5,
              "trace_ids": [1, 2, 3, 4, 5]}
    ours = bytes(procpool.pack_run_frame(header, feeds))
    assert ours == bytes(jprocpool.pack_run_frame(header, feeds))
    h, arrays = jprocpool.unpack_frame(ours)
    assert h == header
    np.testing.assert_array_equal(arrays["x"],
                                  np.stack([f["x"] for f in feeds]))
    np.testing.assert_array_equal(arrays["z"],
                                  np.stack([f["z"] for f in feeds]))


def test_frame_crc_roundtrip_and_blob_flip():
    """A flipped payload byte surfaces as a typed FrameCorrupt that still
    carries the parsed header (attributable to one request), in both
    packages; a header flip stays a ProtocolError."""
    arrs = {"y": np.arange(12, dtype=np.float32).reshape(3, 4)}
    buf = bytes(procpool.pack_frame({"type": "res", "req": 7}, arrs))
    header, out = procpool.unpack_frame(buf)
    assert header["req"] == 7
    np.testing.assert_array_equal(out["y"], arrs["y"])

    flipped = bytearray(buf)
    flipped[-3] ^= 0x40                    # inside the blob region
    with pytest.raises(FrameCorrupt) as ei:
        procpool.unpack_frame(bytes(flipped))
    assert ei.value.header["req"] == 7
    with pytest.raises(JFrameCorrupt):
        jprocpool.unpack_frame(bytes(flipped))

    hdr_flip = bytearray(buf)
    hdr_flip[procpool._HDR_OFF] ^= 0x40
    with pytest.raises(procpool.ProtocolError, match="unreadable header"):
        procpool.unpack_frame(bytes(hdr_flip))


def test_chaos_frame_flip_targets_payload_frames():
    hb = bytes(procpool.pack_frame({"type": "hb", "w": 0, "seq": 1}))
    res = bytes(procpool.pack_frame({"type": "res", "req": 3},
                                    {"y": np.ones(4, np.float32)}))
    with chaos.inject() as c:
        c.corrupt_frames(1)
        assert c.maybe_flip_frame(hb) == hb          # passthrough
        assert c.stats()["frame_flips"] == 0         # arm unconsumed
        bad = c.maybe_flip_frame(res)
        assert bad != res and c.stats()["frame_flips"] == 1
        assert c.maybe_flip_frame(res) == res        # one-shot
    with pytest.raises(FrameCorrupt):
        procpool.unpack_frame(bad)
    procpool.unpack_frame(res)


# --------------------------------------------------------------------------
# sticky device faults
# --------------------------------------------------------------------------


class _AcceleratorError(RuntimeError):
    """Stands in for torch.AcceleratorError (matched by name)."""


_AcceleratorError.__name__ = "AcceleratorError"


def _raises(exc):
    def sync():
        raise exc
    return sync


def _plan_error(inner):
    from repro_torch.core.execplan import PlanError
    try:
        try:
            raise inner
        except Exception as e:
            raise PlanError(f"m: lowered kernel conv_1@op failed: "
                            f"{type(e).__name__}: {e}") from e
    except PlanError as e:
        return e


STICKY = [
    # (batch error, synchronize behaviour, context lost?)
    ("illegal address, sync raises",
     RuntimeError("CUDA error: an illegal memory access was encountered"),
     _raises(RuntimeError("CUDA error: an illegal memory access")), True),
    ("AcceleratorError wrapped in PlanError, sync raises",
     _plan_error(_AcceleratorError("device-side assert triggered")),
     _raises(_AcceleratorError("device-side assert triggered")), True),
    ("launch refused, sync returns",
     RuntimeError("neutron_matmul kernel launch failed: CUDA error 9 "
                  "(invalid configuration argument)"),
     lambda: None, False),
    ("plan error from a chaos fault, not CUDA",
     _plan_error(ValueError("poisoned")),
     _raises(RuntimeError("CUDA error: never reached")), False),
    ("plain RuntimeError",
     RuntimeError("model 'm' unavailable"),
     _raises(RuntimeError("CUDA error: never reached")), False),
]


@pytest.mark.parametrize("err,sync,lost", [c[1:] for c in STICKY],
                         ids=[c[0] for c in STICKY])
def test_device_context_lost_classifies_errors(err, sync, lost):
    assert procpool.device_context_lost(err, sync) is lost


# --------------------------------------------------------------------------
# serving parity with the reference's process pool
# --------------------------------------------------------------------------


def _maps(pid):
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


@pytest.mark.chaos
def test_process_pool_matches_reference_and_children_have_no_jax(tmp_path):
    """Both packages' process pools load the same artifact; the port's
    stored ints equal the reference's at batches 1, 3, 8 and a ragged 5
    (a batch dispatches when full or when its linger expires); every
    child is another process, on the CPU, and has no JAX loaded."""
    m = japi.compile(random_graph(2), precision="int8", cache=False)
    path = m.save(str(tmp_path / "m.rpa"))
    kw = dict(workers=("process", 2), max_batch=8, linger_ms=150.0,
              heartbeat_timeout_s=2.0)
    sj = japi.Session(**kw)
    st = api.Session(device="cpu", **kw)
    try:
        sj.load(path, name="m")
        st.load(path, name="m")
        seen = []
        for batch, seed in ((1, 0), (3, 1), (8, 2), (5, 3)):
            xs = _inputs(st["m"].graph, batch, seed)
            tj = [sj.submit("m", x) for x in xs]
            tt = [st.submit("m", x) for x in xs]
            for a, b in zip(tt, tj):
                got, want = a.result(timeout=60), b.result(timeout=60)
                assert set(got) == set(want)
                for k, w in want.items():
                    assert np.array_equal(got[k].numpy(), np.asarray(w)), k
            seen.append(st.stats()["models"]["m"]["max_batch_seen"])
        assert seen == [1, 3, 8, 8]
        assert st.stats()["models"]["m"]["requests"] == 17
        children = _ready_children(st)
        pids = {h["pid"] for h in children}
        assert len(pids) == 2 and os.getpid() not in pids
        assert {h["device"] for h in children} == {"cpu"}
        assert "jaxlib" in _maps(os.getpid())      # the probe sees JAX
        for pid in pids:
            assert "jaxlib" not in _maps(pid), pid
        assert "repro_worker_pid" in st.metrics()
    finally:
        sj.close()
        st.close()


@pytest.mark.chaos
def test_child_load_error_raises_on_add_and_shows_in_health(tmp_path):
    """A child never serves a model it could not load from anywhere
    else: registering an artifact it cannot open raises, and the
    error shows in ``worker_health()``."""
    sess = _proc_session(n=1)
    try:
        bad = tmp_path / "missing.rpa"
        with pytest.raises(RuntimeError, match="could not load"):
            sess._pool.register_model("bad", str(bad))
        errors = [h["error"] for h in _ready_children(sess)]
        assert errors and all("bad" in e for e in errors), errors
        x = _feed(sess)
        _check_output(sess, "m0", sess.submit("m0", x).result(timeout=30),
                      x)                   # the good model serves on
    finally:
        sess.close()


# --------------------------------------------------------------------------
# crash and frame faults: zero ticket loss
# --------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.parametrize("mode", ["kill", "segv", "oom"])
def test_process_pool_crash_zero_ticket_loss(mode):
    """SIGKILL / SIGSEGV / the OOM exit of a worker process with its
    batch in flight: the batch re-dispatches to survivors, every ticket
    resolves correctly, and the replacement worker spawns off the
    request path."""
    sess = _proc_session()
    try:
        feeds = [_feed(sess, seed=i) for i in range(10)]
        with chaos.inject() as c:
            c.kill_worker(-1, mode=mode)
            ts = [sess.submit("m0", f) for f in feeds]
            for t, f in zip(ts, feeds):
                _check_output(sess, "m0", t.result(timeout=30), f)
            assert c.stats()["kills"] == 1
        assert sess.stats()["models"]["m0"]["crash_redispatches"] >= 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = sess.stats()["pool"]
            if st.get("recycled_workers", 0) >= 1 and \
                    len(_ready_children(sess)) >= 4:
                break
            time.sleep(0.1)
        assert sess.stats()["pool"]["recycled_workers"] >= 1
        # two lanes a child: four ready lanes are two live children, and
        # no replacement lane joined the dying process
        ready = _ready_children(sess)
        assert len(ready) >= 4
        assert len({h["pid"] for h in ready}) == 2
        assert all(h["exitcode"] is None for h in ready)
        x = feeds[0]
        _check_output(sess, "m0", sess.submit("m0", x).result(timeout=30),
                      x)
    finally:
        sess.close()


@pytest.mark.chaos
def test_process_pool_frame_corruption_zero_ticket_loss():
    """A bit-flipped reply frame fails only its own batch — the batch
    re-dispatches and every ticket still resolves with parity, with no
    worker recycled."""
    sess = _proc_session()
    try:
        feeds = [_feed(sess, seed=i) for i in range(8)]
        with chaos.inject() as c:
            c.corrupt_frames(1)
            ts = [sess.submit("m0", f) for f in feeds]
            for t, f in zip(ts, feeds):
                _check_output(sess, "m0", t.result(timeout=30), f)
            assert c.stats()["frame_flips"] == 1
        assert sess.stats()["models"]["m0"]["frame_corrupt"] >= 1
        assert sess.stats()["pool"]["recycled_workers"] == 0
    finally:
        sess.close()


@pytest.mark.chaos
def test_recycled_lanes_never_join_the_dying_process():
    """The supervisor recycling both lanes of a live child (as heartbeat
    staleness does) spawns a new process for them: no replacement lane
    attaches to the process being killed, so each lane is recycled once
    (the reference's pool attaches both and recycles them again)."""
    sess = _proc_session()
    try:
        pool = sess._pool
        with pool._cv:
            lanes = sorted(w for w, p in pool._lane_proc.items()
                           if p.wid == 0)
            doomed = pool._lane_proc[lanes[0]]
            for w in lanes:
                pool._recycle_locked(w)
            joined = [w for w, p in pool._lane_proc.items() if p is doomed]
        assert len(lanes) == 2 and joined == []
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(_ready_children(sess)) < 4:
            time.sleep(0.1)
        time.sleep(1.0)            # a second recycle would come by now
        assert pool.counters["recycled_workers"] == 2
        ready = _ready_children(sess)
        assert len(ready) == 4 and doomed.pid not in {h["pid"] for h in ready}
        x = _feed(sess)
        _check_output(sess, "m0", sess.submit("m0", x).result(timeout=30),
                      x)
    finally:
        sess.close()
