"""Compiler driver: graph -> timed NPU program (paper §IV end-to-end).

``compile_graph`` chains the mid-end passes — format selection, temporal
tiling + layer fusion, tick DAE scheduling, memory allocation — and
returns the compiled program plus per-phase diagnostics.  The
:class:`CompilerOptions` knobs expose exactly the ablations the paper
evaluates:

  * ``baseline()``        — the eNPU-A-style reference stack: single
    (depth) format, layer-by-layer execution (no fusion), no DAE overlap.
    Used for the Table III speedup comparisons.
  * ``partition=False``   — monolithic CP (Table II row 1).
  * ``fusion=False``      — no layer fusion (Fig. 6 "without").
  * ``seed_solver()``     — the original (PR-0) compiler hot path:
    full-rescan CP engine, serial partition solving, no cost memo.  The
    perf baseline timed by ``benchmarks/compile_bench.py``.

Repeated serving compiles of the same model hit the content-addressed
**compiled-program cache**: the key is (canonical ``Graph`` structure
hash, ``NPUConfig``, compile options), so a cache hit returns the
previously compiled ``NPUProgram`` without re-running any pass, and any
change to the graph topology, hardware config or options misses.
Programs are treated as immutable once allocated.

The cache is **two-tier**: a bounded in-process LRU (configurable entry
and byte caps) in front of an optional on-disk artifact directory
(``program_cache_configure(disk_dir=...)`` or the
``REPRO_PROGRAM_CACHE_DIR`` environment variable).  Disk entries are the
versioned, checksummed artifacts of :mod:`repro_torch.core.serialize`, keyed
by a digest of the same (fingerprint, config, options) triple — a
serving fleet process that misses in memory loads the program from disk
instead of re-running the CP solver, and a corrupted or stale artifact
is rejected (and recompiled), never silently replayed.

Copy of the JAX package's ``core/pipeline.py`` (pure Python; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.  It reads the same ``REPRO_PROGRAM_CACHE_DIR``
and writes the same artifact bytes, so one disk cache serves both
packages.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, fields, replace
from typing import Dict, Optional, Tuple

from ..obs import trace as _trace
from . import cpsolver, serialize
from .allocation import Allocation, AllocationError, allocate
from .formats import FORMATS, FormatPlan, select_formats
from .ir import Graph, graph_precision
from .npu import NPUConfig
from .program import NPUProgram
from .scheduling import SchedOptions, schedule
from .tiling import TilingResult, plan_tiling


@dataclass
class CompilerOptions:
    formats: tuple = FORMATS          # allowed parallelism formats
    fusion: bool = True               # layer fusion CP (§IV-C)
    naive_tiling: bool = False        # reference-stack tile bounds
    overlap: bool = True              # DAE overlap (§IV-B)
    partition: bool = True            # partition the CP problems
    partition_steps: int = 12
    # the incremental engine converges far faster than the seed engine,
    # so the default per-subproblem deadline is tighter; seed_solver()
    # keeps the historical 1.0 s
    cp_time_limit_s: float = 0.6      # per subproblem
    monolithic_time_limit_s: float = 20.0
    dm_penalty: int = 16
    cp_stall_s: Optional[float] = None  # CP early exit: stall wall-time
    cp_stall_nodes: Optional[int] = \
        cpsolver.DEFAULT_STALL_NODES      # …or stall search nodes
    parallel_cp: bool = True          # solve partitions on a process pool
    cp_engine: str = "incremental"    # cpsolver.ENGINES key
    # fusion-CP scale (§IV-C): regions whose estimated tile count fits
    # max_cp_tiles get the joint tile-size + order CP; bigger regions
    # are decomposed into overlapping windows of <= max_cp_window_tiles
    # greedy steps (region_overlap steps shared between neighbours),
    # solved concurrently and stitched.  max_cp_window_tiles=0 disables
    # windowing — oversized regions then fall back to the greedy order.
    max_cp_tiles: int = 36
    max_cp_window_tiles: int = 24
    region_overlap: int = 6
    # requested execution precision.  "auto" compiles whatever the graph
    # is annotated with; "float32"/"int8" assert the graph matches (a
    # quantized request must have gone through repro_torch.quant.quantize_graph
    # — the compiler never quantizes implicitly).  Part of the cache key.
    precision: str = "auto"

    @staticmethod
    def baseline() -> "CompilerOptions":
        """The reference embedded-NPU compiler behaviour (§V eNPU-A/B)."""
        return CompilerOptions(formats=("depth",), fusion=False,
                               overlap=False, naive_tiling=True)

    @staticmethod
    def seed_solver() -> "CompilerOptions":
        """The pre-overhaul compiler hot path (same search quality knobs,
        original full-rescan engine, serial partitions, no stall exit)."""
        return CompilerOptions(cp_engine="reference", parallel_cp=False,
                               cp_stall_s=None, cp_stall_nodes=None,
                               cp_time_limit_s=1.0)

    def cache_key(self) -> Tuple:
        return tuple(getattr(self, f.name) for f in fields(self))


@dataclass
class CompileResult:
    program: NPUProgram
    plan: FormatPlan
    tiling: TilingResult
    allocation: Allocation
    compile_s: float
    phase_s: Dict[str, float] = field(default_factory=dict)
    cache_hit: bool = False
    cache_key: Optional[str] = None
    cache_tier: Optional[str] = None     # "memory" | "disk" | None (solved)

    def stats(self) -> Dict[str, float]:
        s = self.program.stats()
        s["compile_s"] = self.compile_s
        s.update({f"phase_{k}_s": v for k, v in self.phase_s.items()})
        return s


# --------------------------------------------------------------------------
# Compiled-program cache (two tiers: in-process LRU + on-disk artifacts)
# --------------------------------------------------------------------------

_CACHE_LOCK = threading.Lock()
#: key -> (result, estimated resident bytes)
_PROGRAM_CACHE: "OrderedDict[Tuple, Tuple[CompileResult, int]]" = \
    OrderedDict()
_CACHE_MAX_ENTRIES = 64
_CACHE_MAX_BYTES: Optional[int] = None
_CACHE_BYTES = 0
_CACHE_DISK_DIR: Optional[str] = \
    os.environ.get("REPRO_PROGRAM_CACHE_DIR") or None
_CACHE_DISK_MAX_BYTES: Optional[int] = None

_STATS_ZERO = {"mem_hits": 0, "mem_misses": 0, "mem_evictions": 0,
               "disk_hits": 0, "disk_misses": 0, "disk_writes": 0,
               "disk_rejects": 0, "disk_evictions": 0}
_CACHE_STATS = dict(_STATS_ZERO)
#: graph fingerprints exempt from LRU eviction (Session admission
#: policy: pinned hot models stay resident even under cap pressure).
_PINNED_FPS: set = set()

_UNSET = object()


def _estimate_result_bytes(res: CompileResult) -> int:
    """Cheap structural estimate of a cached entry's resident footprint
    (Python object overhead dominates; tile data lives in DRAM/TCM at
    run time, not in the program)."""
    n_jobs = sum(1 + len(t.dma) + len(t.v2p) for t in res.program.ticks)
    n_tiles = sum(len(tt.tiles) for tt in res.tiling.tiles.values())
    return 400 * n_jobs + 200 * (n_tiles + len(res.tiling.order)) + 4096


def program_cache_configure(max_entries: Optional[int] = None,
                            max_bytes=_UNSET, disk_dir=_UNSET,
                            disk_max_bytes=_UNSET) -> None:
    """Reconfigure the two-tier store.  ``max_entries``/``max_bytes``
    bound the in-process LRU (None byte cap = unbounded bytes);
    ``disk_dir`` enables (a path) or disables (None) the disk tier;
    ``disk_max_bytes`` caps the disk tier's total artifact bytes (None =
    unbounded) — past the cap the least-recently-served ``.rpa`` files
    are garbage-collected, counted by ``disk_evictions`` in
    :func:`program_cache_info`."""
    global _CACHE_MAX_ENTRIES, _CACHE_MAX_BYTES, _CACHE_DISK_DIR, \
        _CACHE_DISK_MAX_BYTES
    with _CACHE_LOCK:
        if max_entries is not None:
            _CACHE_MAX_ENTRIES = int(max_entries)
        if max_bytes is not _UNSET:
            _CACHE_MAX_BYTES = None if max_bytes is None else int(max_bytes)
        if disk_dir is not _UNSET:
            _CACHE_DISK_DIR = disk_dir
        if disk_max_bytes is not _UNSET:
            _CACHE_DISK_MAX_BYTES = None if disk_max_bytes is None \
                else int(disk_max_bytes)
        _evict_locked()
    if disk_dir is not _UNSET or disk_max_bytes is not _UNSET:
        d = _disk_dir_snapshot()
        if d:
            _disk_gc(d)


def program_cache_clear(stats: bool = True) -> None:
    """Drop every in-memory entry (the disk tier is persistent by design;
    remove its directory to clear it).  ``stats=True`` also zeroes the
    hit/miss/evict counters."""
    global _CACHE_BYTES
    with _CACHE_LOCK:
        _PROGRAM_CACHE.clear()
        _CACHE_BYTES = 0
        if stats:
            _CACHE_STATS.update(_STATS_ZERO)


def program_cache_info() -> Dict[str, int]:
    with _CACHE_LOCK:
        info = {"entries": len(_PROGRAM_CACHE), "max": _CACHE_MAX_ENTRIES,
                "max_entries": _CACHE_MAX_ENTRIES,
                "bytes": _CACHE_BYTES, "max_bytes": _CACHE_MAX_BYTES,
                "disk_dir": _CACHE_DISK_DIR,
                "disk_max_bytes": _CACHE_DISK_MAX_BYTES,
                "pinned_fps": len(_PINNED_FPS),
                "pinned_entries": sum(1 for k in _PROGRAM_CACHE
                                      if k[0] in _PINNED_FPS)}
        info.update(_CACHE_STATS)
    disk_dir = info["disk_dir"]
    info["disk_entries"] = 0
    info["disk_bytes"] = 0
    if disk_dir and os.path.isdir(disk_dir):
        for f in os.listdir(disk_dir):
            if not f.endswith(".rpa"):
                continue
            info["disk_entries"] += 1
            try:
                info["disk_bytes"] += os.path.getsize(
                    os.path.join(disk_dir, f))
            except OSError:
                pass              # raced with GC / external cleanup
    return info


def _evict_locked() -> None:
    global _CACHE_BYTES
    while _PROGRAM_CACHE and (
            len(_PROGRAM_CACHE) > _CACHE_MAX_ENTRIES or
            (_CACHE_MAX_BYTES is not None and
             _CACHE_BYTES > _CACHE_MAX_BYTES)):
        # LRU order, skipping pinned entries.  If only pinned entries
        # remain the store is allowed to exceed its caps — pinning is an
        # explicit operator decision and must never be silently undone.
        victim = next((k for k in _PROGRAM_CACHE
                       if k[0] not in _PINNED_FPS), None)
        if victim is None:
            break
        _, nb = _PROGRAM_CACHE.pop(victim)
        _CACHE_BYTES -= nb
        _CACHE_STATS["mem_evictions"] += 1


def program_cache_pin(fingerprint: str) -> None:
    """Exempt every cache entry of this graph fingerprint (present or
    future) from in-process LRU eviction."""
    with _CACHE_LOCK:
        _PINNED_FPS.add(fingerprint)


def program_cache_unpin(fingerprint: str) -> None:
    with _CACHE_LOCK:
        _PINNED_FPS.discard(fingerprint)
        _evict_locked()


def _cache_get(key: Tuple) -> Optional[CompileResult]:
    with _CACHE_LOCK:
        entry = _PROGRAM_CACHE.get(key)
        if entry is not None:
            _PROGRAM_CACHE.move_to_end(key)
            _CACHE_STATS["mem_hits"] += 1
            return entry[0]
        _CACHE_STATS["mem_misses"] += 1
        return None


def _cache_put(key: Tuple, res: CompileResult) -> None:
    global _CACHE_BYTES
    nb = _estimate_result_bytes(res)
    with _CACHE_LOCK:
        old = _PROGRAM_CACHE.pop(key, None)
        if old is not None:
            _CACHE_BYTES -= old[1]
        _PROGRAM_CACHE[key] = (res, nb)
        _CACHE_BYTES += nb
        _evict_locked()


# ---- disk tier -----------------------------------------------------------
# The disk directory is snapshotted once per compile (under the lock)
# and passed down, so a concurrent program_cache_configure(disk_dir=...)
# cannot yank the global out from under an in-flight compile; counter
# updates take the lock like the memory tier's.


def _bump(counter: str, n: int = 1) -> None:
    with _CACHE_LOCK:
        _CACHE_STATS[counter] += n


#: fault-injection hook for the disk tier (the serving runtime's chaos
#: harness, ROADMAP.md item 6b):
#: called with the artifact path before every disk read; raising
#: ArtifactError exercises the reject-and-recompile path.  None in
#: production.
_DISK_READ_HOOK = None


def set_disk_read_hook(fn):
    """Install (or clear, with None) the disk-read fault-injection
    hook; returns the previous hook so callers can restore it."""
    global _DISK_READ_HOOK
    prev = _DISK_READ_HOOK
    _DISK_READ_HOOK = fn
    return prev


def _disk_dir_snapshot() -> Optional[str]:
    with _CACHE_LOCK:
        return _CACHE_DISK_DIR


def _disk_gc(disk_dir: str) -> None:
    """Evict oldest artifacts once the disk tier exceeds its byte cap.

    "Oldest" is least-recently-*served*: a disk hit touches the file's
    mtime, so hot programs survive the sweep.  Unlink races (another
    process GC-ing the same shared dir) are benign — whoever loses the
    race just skips the file."""
    with _CACHE_LOCK:
        cap = _CACHE_DISK_MAX_BYTES
    if cap is None or not os.path.isdir(disk_dir):
        return
    entries = []
    for f in os.listdir(disk_dir):
        if not f.endswith(".rpa"):
            continue
        p = os.path.join(disk_dir, f)
        try:
            st = os.stat(p)
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, p))
    total = sum(sz for _, sz, _ in entries)
    for _, sz, p in sorted(entries):
        if total <= cap:
            return
        try:
            os.unlink(p)
        except OSError:
            continue
        _bump("disk_evictions")
        total -= sz


def _disk_path(disk_dir: str, fp: str, cfg: NPUConfig,
               opts: "CompilerOptions") -> str:
    digest = serialize.cache_file_key(fp, cfg, opts.cache_key())
    return os.path.join(disk_dir, f"{digest}.rpa")


def _disk_get(disk_dir: str, fp: str, cfg: NPUConfig,
              opts: "CompilerOptions") -> Optional[CompileResult]:
    path = _disk_path(disk_dir, fp, cfg, opts)
    if not os.path.exists(path):
        _bump("disk_misses")
        return None
    t = time.monotonic()
    try:
        if _DISK_READ_HOOK is not None:
            _DISK_READ_HOOK(path)
        key, payloads, _ = serialize.read_artifact(path)
        if (key.get("fingerprint") != fp or
                key.get("cfg") != serialize.config_to_payload(cfg) or
                key.get("opts") !=
                serialize.options_digest(opts.cache_key())):
            raise serialize.ArtifactError(
                f"{path}: stale artifact (key mismatch)")
        res = CompileResult(
            serialize.program_from_payload(payloads["program"]),
            serialize.plan_from_payload(payloads["plan"]),
            serialize.tiling_from_payload(payloads["tiling"]),
            serialize.allocation_from_payload(payloads["allocation"]),
            compile_s=0.0,
            phase_s={"disk_load": time.monotonic() - t},
            cache_hit=True, cache_key=fp, cache_tier="disk")
    except (serialize.ArtifactError, OSError):
        # reject, never replay — and degrade to a recompile on any I/O
        # error (file vanished between exists() and open, permissions,
        # …): the disk tier must never fail a serving compile.  A fresh
        # compile overwrites the bad file.
        _bump("disk_rejects")
        _bump("disk_misses")
        return None
    try:
        os.utime(path)            # mark recently-served for the GC sweep
    except OSError:
        pass
    _bump("disk_hits")
    return res


def _disk_put(disk_dir: str, fp: str, cfg: NPUConfig,
              opts: "CompilerOptions", res: CompileResult) -> None:
    os.makedirs(disk_dir, exist_ok=True)
    path = _disk_path(disk_dir, fp, cfg, opts)
    key = {"fingerprint": fp, "cfg": serialize.config_to_payload(cfg),
           "opts": serialize.options_digest(opts.cache_key())}
    payloads = {
        "program": serialize.program_to_payload(res.program),
        "plan": serialize.plan_to_payload(res.plan),
        "tiling": serialize.tiling_to_payload(res.tiling),
        "allocation": serialize.allocation_to_payload(res.allocation),
    }
    fd, tmp = tempfile.mkstemp(dir=disk_dir, suffix=".tmp")
    os.close(fd)
    try:
        serialize.write_artifact(tmp, key, payloads)
        os.replace(tmp, path)     # atomic vs concurrent readers
        _bump("disk_writes")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def compile_graph(g: Graph, cfg: NPUConfig,
                  opts: Optional[CompilerOptions] = None,
                  cache: bool = True) -> CompileResult:
    opts = opts or CompilerOptions()
    t0 = time.monotonic()

    if opts.precision != "auto":
        got = graph_precision(g)
        if got != opts.precision:
            raise ValueError(
                f"CompilerOptions(precision={opts.precision!r}) but graph "
                f"{g.name!r} is annotated {got!r} — run "
                f"repro_torch.quant.quantize_graph (or cast_graph) first")

    key = fp = None
    if cache:
        fp = g.fingerprint()
        key = (fp, cfg, opts.cache_key())
        hit = _cache_get(key)
        if hit is not None:
            _trace.instant("program_cache", "compile",
                           args={"model": g.name, "tier": "memory"})
            # same shared (immutable) program/tiling/allocation objects;
            # fresh timing envelope for this call
            return replace(hit, compile_s=time.monotonic() - t0,
                           phase_s=dict(hit.phase_s, cache_hit=0.0),
                           cache_hit=True, cache_tier="memory")
        disk_dir = _disk_dir_snapshot()
        if disk_dir:
            disk = _disk_get(disk_dir, fp, cfg, opts)
            if disk is not None:
                _trace.instant("program_cache", "compile",
                               args={"model": g.name, "tier": "disk"})
                _cache_put(key, disk)
                return replace(disk, compile_s=time.monotonic() - t0)
    _trace.instant("program_cache", "compile",
                   args={"model": g.name,
                         "tier": "miss" if cache else "bypass"})

    phase: Dict[str, float] = {}
    tr = _trace.active()
    t = time.monotonic()
    plan = select_formats(cfg, g, allowed=opts.formats)
    phase["formats"] = time.monotonic() - t
    if tr is not None:
        tr.complete("compile:formats", "compile", t,
                    t + phase["formats"], args={"model": g.name})

    sched_opt = SchedOptions(
        overlap=opts.overlap,
        partition=opts.partition,
        partition_steps=opts.partition_steps,
        cp_time_limit_s=(opts.cp_time_limit_s if opts.partition
                         else opts.monolithic_time_limit_s),
        cp_stall_s=opts.cp_stall_s,
        cp_stall_nodes=opts.cp_stall_nodes,
        parallel_cp=opts.parallel_cp,
        cp_engine=opts.cp_engine,
        dm_penalty=opts.dm_penalty,
    )
    # tile-budget ladder: a working set that over-subscribes the TCM at
    # schedule or allocation time is retried with finer tiles (the
    # paper's "partitioned into smaller sub-problems" escape hatch,
    # §III-B).  Within a rung, allocation failures first retry with pure
    # JIT placement (no CP re-timing) before descending.
    #
    # When windowed fusion produced a stitched order that differs from
    # the greedy one, plan_tiling attaches the greedy-order variant as
    # `tiling.fallback` (same tiles, no re-solving) and the rung races
    # both through the scheduler, keeping whichever program the DAE
    # latency model scores better: the window CP's memory objective is a
    # proxy, and the guarantee that windowing never loses vs greedy
    # comes from this race, not from the proxy.
    t = time.monotonic()
    last_err: Optional[Exception] = None
    prog = alloc = tiling = None
    for frac in (0.5, 0.25, 0.125, 0.0625, 0.03125):
        ti = plan_tiling(cfg, g, plan, fusion=opts.fusion,
                         cp_time_limit_s=opts.cp_time_limit_s,
                         max_cp_tiles=opts.max_cp_tiles,
                         budget_frac=frac,
                         naive=opts.naive_tiling,
                         cp_stall_s=opts.cp_stall_s,
                         cp_stall_nodes=opts.cp_stall_nodes,
                         parallel_cp=opts.parallel_cp,
                         cp_engine=opts.cp_engine,
                         max_cp_window_tiles=opts.max_cp_window_tiles,
                         region_overlap=opts.region_overlap)
        best = None
        for cand in ([ti] if ti.fallback is None else [ti, ti.fallback]):
            got = None
            for so in (sched_opt,
                       replace(sched_opt, cp_time_limit_s=0.0)):
                try:
                    p = schedule(cfg, g, plan, cand, so)
                    a = allocate(p, cfg)
                    got = (p, a, cand)
                    last_err = None
                    break
                except (RuntimeError, AllocationError) as e:
                    last_err = e
                    continue
            if got is not None and (
                    best is None or
                    (got[0].latency_cycles(), got[0].ddr_bytes()) <
                    (best[0].latency_cycles(), best[0].ddr_bytes())):
                best = got
        if best is not None:
            prog, alloc, tiling = best
            tiling.fallback = None       # not part of the compiled result
            last_err = None
            break
    if last_err is not None:
        raise last_err
    phase["schedule_allocate"] = time.monotonic() - t
    if tr is not None:
        tr.complete("compile:schedule_allocate", "compile", t,
                    t + phase["schedule_allocate"],
                    args={"model": g.name})

    res = CompileResult(prog, plan, tiling, alloc,
                        time.monotonic() - t0, phase,
                        cache_hit=False, cache_key=fp)
    if tr is not None:
        tr.complete("compile", "compile", t0,
                    args={"model": g.name, "precision": opts.precision})
    if cache and key is not None:
        _cache_put(key, res)
        disk_dir = _disk_dir_snapshot()
        if disk_dir:
            t = time.monotonic()
            try:
                _disk_put(disk_dir, fp, cfg, opts, res)
                _disk_gc(disk_dir)
                phase["disk_store"] = time.monotonic() - t
            except OSError:
                pass              # disk tier is best-effort
    return res
