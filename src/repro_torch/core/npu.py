"""Neutron NPU machine model (paper §III).

This is the analytical performance model of the eIQ Neutron subsystem the
compiler optimizes against — the "hardware half" of the co-design.  The
container has no NPU silicon, so the model plays the role the cycle
estimator plays inside the real compiler: it converts (job, tile, format)
into cycles, and the scheduler's objective (Eq. 8) is evaluated against it.

Model summary (paper §III-B/C):
  * ``cores`` compute cores; each has M pipelined dot-product units of
    vector length N -> 2*N*M ops/cycle/core.  N=M=16, 4 cores @1 GHz
    = 2.048 TOPS (the paper's 2-TOPS configuration).
  * One operand vector is broadcast to all M units (N bytes/cycle input
    bandwidth at full rate); the other operand can be held stationary in a
    per-core weight scratchpad W_C (8 KiB) or streamed.
  * A accumulators per unit (A = 2M = 32) allow A output pixels in flight,
    dividing the non-shared operand bandwidth by A.
  * Fused epilogue: rescale + activation + min/max pool at no extra cost.
  * Three 128-bit buses per core; TCM is multi-banked and non-arbitrated —
    conflicts are the *compiler's* job to avoid (scheduling constraint #3).
  * DMA: multi-dimensional strided DDR<->TCM and TCM<->TCM transfers.

Every returned latency is in cycles at ``freq`` (1 GHz default) so cycles
== nanoseconds; helpers convert to ms.

Copy of the JAX package's ``core/npu.py`` (pure Python; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import Dict, Optional, Tuple

from .ir import DTYPE_BYTES, Graph, Op


def elem_bytes(dtype: str) -> float:
    """Storage bytes per element (int4 is nibble-packed: 0.5)."""
    return DTYPE_BYTES.get(dtype, 4.0)


def mac_rate(dtype: str) -> float:
    """MAC-array throughput multiplier vs the native int8 rate.

    The Neutron dot-product units are sized for 8-bit operands (paper
    §III-B): int8/int4 operands run the N-wide vector at full rate, while
    16/32-bit operands halve the effective vector length (two byte lanes
    per element pair) — i.e. quantized layers get the paper's 2x MAC
    throughput over a float32 fallback at identical silicon."""
    return 1.0 if dtype in ("int4", "int8") else 0.5


@dataclass(frozen=True)
class NPUConfig:
    """Hardware parameters.  Defaults = the paper's 2-TOPS MPU instance
    (N=M=16, A=2M, W_C=8KiB, 4 cores, 1 MiB TCM, 12 GB/s DDR)."""

    name: str = "neutron-2tops"
    cores: int = 4
    M: int = 16                      # dot-product units per core
    N: int = 16                      # dot-product vector length
    A: int = 32                      # accumulators per unit (2M)
    Wc_bytes: int = 8 * 1024         # per-core weight scratchpad
    freq_hz: float = 1.0e9
    tcm_bytes: int = 1 * 1024 * 1024
    tcm_banks: int = 32              # non-arbitrated banks
    bus_bytes: int = 16              # 128-bit operand/result buses
    n_buses: int = 3
    ddr_gbps: float = 12.0           # DDR bandwidth (GB/s)
    tcm_gbps: float = 64.0           # aggregate TCM bandwidth (GB/s)
    dma_setup_cycles: int = 400      # per DMA job programming overhead
    job_setup_cycles: int = 300      # per compute-job programming overhead
    v2p_cycles: int = 64             # V2P table update

    @property
    def peak_tops(self) -> float:
        return 2 * self.N * self.M * self.cores * self.freq_hz / 1e12

    @property
    def bank_bytes(self) -> int:
        return self.tcm_bytes // self.tcm_banks

    @property
    def ddr_bytes_per_cycle(self) -> float:
        return self.ddr_gbps * 1e9 / self.freq_hz

    @property
    def tcm_bytes_per_cycle(self) -> float:
        return self.tcm_gbps * 1e9 / self.freq_hz

    def scaled(self, factor: float) -> "NPUConfig":
        """eNPU-B-style scaling: x`factor` TOPS, SRAM and DDR bandwidth."""
        return replace(
            self,
            name=f"{self.name}-x{factor:g}",
            cores=int(self.cores * factor),
            tcm_bytes=int(self.tcm_bytes * factor),
            tcm_banks=int(self.tcm_banks * factor),
            ddr_gbps=self.ddr_gbps * factor,
            tcm_gbps=self.tcm_gbps * factor,
        )


#: the two reference configurations of paper §V.
NEUTRON_2TOPS = NPUConfig()
ENPU_A = replace(NPUConfig(), name="enpu-a")        # equal resources
ENPU_B = NPUConfig().scaled(2.0)                    # 2x resources


# --------------------------------------------------------------------------
# Compute-job cost model
# --------------------------------------------------------------------------


@dataclass
class JobCost:
    cycles: int
    macs: int
    in_bytes: int
    w_bytes: int
    out_bytes: int
    bound: str  # "compute" | "operand-bw" | "weight-bw" | "output-bw"

    @property
    def util(self) -> float:
        return self.macs / max(self.cycles, 1)


def _dot_engine_cycles(cfg: NPUConfig, out_pixels: int, out_c: int,
                       dot_len: int, engines: int,
                       weights_stationary: bool,
                       act_eb: float = 1.0, w_eb: float = 1.0,
                       rate: float = 1.0) -> Tuple[int, str]:
    """Cycles for one core-group to produce `out_pixels x out_c` results,
    each a dot product of length `dot_len`, spread over `engines` cores.

    Within a core: M units each produce one output-channel result per
    pass; A accumulators keep A pixels in flight.  The paper's bandwidth
    argument: the shared operand (ifmap in depth parallelism) needs
    N * act_eb bytes/cycle; the non-shared one (weights) is either
    stationary in W_C or streamed with A-fold reuse.

    ``act_eb``/``w_eb`` are bytes/element of the streamed activation and
    weight operands; ``rate`` is the MAC-array throughput multiplier
    (:func:`mac_rate`) — int8 runs the full N-wide vector per cycle,
    float32 half of it.
    """
    if engines <= 0:
        engines = 1
    # --- pure MAC throughput (with padding to lockstep, paper §IV-A)
    oc_per_engine = math.ceil(out_c / engines) if out_c else 0
    if oc_per_engine == 0 or out_pixels == 0 or dot_len == 0:
        return 0, "compute"
    oc_passes = math.ceil(oc_per_engine / cfg.M)
    dot_cycles = math.ceil(dot_len / (cfg.N * rate))
    compute = out_pixels * oc_passes * dot_cycles

    # --- operand (shared, e.g. ifmap) bandwidth: N*act_eb bytes/cycle
    #     needed, one 128-bit bus provides bus_bytes per cycle.
    operand_rate = min(1.0, cfg.bus_bytes / (cfg.N * act_eb))
    # --- weight bandwidth: stationary weights stream once per W_C refill;
    #     otherwise every pass re-reads them with A-fold pixel reuse.
    w_bytes_total = math.ceil(out_c * dot_len * w_eb)
    if weights_stationary and w_bytes_total <= cfg.Wc_bytes * engines:
        w_stream_cycles = math.ceil(w_bytes_total / (cfg.bus_bytes * engines))
        weight_limited = 0
    else:
        # streamed: per pixel-group of A, each engine re-fetches its slice
        per_engine_w = math.ceil(w_bytes_total / engines)
        refetches = math.ceil(out_pixels / cfg.A)
        w_stream_cycles = math.ceil(per_engine_w * refetches / cfg.bus_bytes)
        weight_limited = w_stream_cycles

    cycles = max(math.ceil(compute / operand_rate), w_stream_cycles)
    if cycles == compute:
        bound = "compute"
    elif cycles == weight_limited:
        bound = "weight-bw"
    else:
        bound = "operand-bw"
    return cycles, bound


_COST_MEMO_ENABLED = True
_JOB_COST_CACHE: Dict[Tuple, JobCost] = {}
_JOB_COST_CACHE_MAX = 1 << 16


def set_cost_memo(enabled: bool) -> None:
    """Toggle the compute/DMA cost memo (benchmarks time both modes)."""
    global _COST_MEMO_ENABLED
    _COST_MEMO_ENABLED = bool(enabled)
    if not enabled:
        cost_cache_clear()


def cost_cache_clear() -> None:
    _JOB_COST_CACHE.clear()
    _dma_cost_cached.cache_clear()


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _job_cost_key(cfg: NPUConfig, g: Graph, op: Op, out_h: int, fmt: str,
                  engines: Optional[int], out_c: Optional[int]) -> Tuple:
    """Everything compute_job_cost reads, as a hashable key — the cost of
    a job depends only on op kind/attrs and operand shapes, never on
    tensor names, so repeated tiles, budget-ladder retries and repeated
    model compiles all hit the same entries."""
    return (cfg, op.kind, _freeze(op.attrs),
            g.tensors[op.output].shape, g.tensors[op.output].dtype,
            tuple((t.shape, t.dtype) for t in g.param_inputs(op)),
            tuple((t.shape, t.dtype) for t in g.act_inputs(op)),
            out_h, fmt, engines, out_c)


def compute_job_cost(cfg: NPUConfig, g: Graph, op: Op,
                     out_h: int, fmt: str, engines: Optional[int] = None,
                     out_c: Optional[int] = None) -> JobCost:
    """Cost of computing `out_h` output lines (restricted to `out_c`
    output channels when the op is channel-partitioned) of `op` in format
    `fmt` ("depth" or "line", paper §IV-A) on `engines` cores.

    Results are memoized (callers treat JobCost as read-only): the tiling
    and scheduling passes re-evaluate identical (op, tile, format) jobs
    thousands of times inside their CP loops."""
    if _COST_MEMO_ENABLED:
        key = _job_cost_key(cfg, g, op, out_h, fmt, engines, out_c)
        hit = _JOB_COST_CACHE.get(key)
        if hit is not None:
            return hit
        jc = _compute_job_cost(cfg, g, op, out_h, fmt, engines, out_c)
        if len(_JOB_COST_CACHE) < _JOB_COST_CACHE_MAX:
            _JOB_COST_CACHE[key] = jc
        return jc
    return _compute_job_cost(cfg, g, op, out_h, fmt, engines, out_c)


def _compute_job_cost(cfg: NPUConfig, g: Graph, op: Op,
                      out_h: int, fmt: str, engines: Optional[int] = None,
                      out_c: Optional[int] = None) -> JobCost:
    engines = engines or cfg.cores
    k = op.kind
    out = g.tensors[op.output]
    if out.kind == "parameter":  # pragma: no cover
        raise ValueError("op writes a parameter?")
    if len(out.shape) == 3:
        H, W, C = out.shape
    else:
        H, W, C = 1, 1, out.shape[0]
    out_h = min(out_h, H)
    c_frac = 1.0
    if out_c is not None and C:
        c_frac = out_c / C
        C = out_c
    a = op.attrs

    # precision: bytes/element of each operand class + MAC-array rate
    # (the paper's MAC arrays are int8-native; see mac_rate()).
    acts = g.act_inputs(op)
    params = g.param_inputs(op)
    act_eb = elem_bytes(acts[0].dtype if acts else out.dtype)
    w_eb = elem_bytes(params[0].dtype) if params else act_eb
    out_eb = elem_bytes(out.dtype)
    rate = min(mac_rate(acts[0].dtype) if acts else 1.0,
               mac_rate(params[0].dtype) if params else 1.0)

    w_bytes = math.ceil(sum(t.bytes for t in params) * c_frac)
    in_bytes = sum(t.bytes for t in acts)
    in_bytes = math.ceil(in_bytes * out_h / max(H, 1))
    out_bytes = math.ceil(out_h * W * C * out_eb)

    if k in ("conv", "fc"):
        wt = params[0]
        oc, fh, fw, ic = wt.shape
        dot_len = fh * fw * ic
        pixels = out_h * W
        if fmt == "depth":
            # split outC over engines; ifmap broadcast-shared
            cyc, bound = _dot_engine_cycles(cfg, pixels, C, dot_len,
                                            engines, weights_stationary=True,
                                            act_eb=act_eb, w_eb=w_eb,
                                            rate=rate)
        else:
            # line: split lines over engines; weights broadcast-shared
            pix_e = math.ceil(out_h / engines) * W
            cyc, bound = _dot_engine_cycles(cfg, pix_e, C, dot_len, 1,
                                            weights_stationary=True,
                                            act_eb=act_eb, w_eb=w_eb,
                                            rate=rate)
        macs = pixels * C * dot_len
    elif k == "dwconv":
        wt = params[0]
        _, fh, fw, _ = wt.shape
        dot_len = fh * fw
        pixels = out_h * W
        if fmt == "depth":
            cyc, bound = _dot_engine_cycles(cfg, pixels,
                                            math.ceil(C / 1), dot_len,
                                            engines, True,
                                            act_eb=act_eb, w_eb=w_eb,
                                            rate=rate)
            # depthwise cannot share the ifmap across channels: each unit
            # needs its own channel stream -> M-fold operand bandwidth.
            cyc = max(cyc, math.ceil(pixels * C * dot_len * act_eb
                                     / (cfg.bus_bytes * engines)))
            bound = "operand-bw" if cyc > pixels else bound
        else:
            pix_e = math.ceil(out_h / engines) * W
            cyc, bound = _dot_engine_cycles(cfg, pix_e, C, dot_len, 1, True,
                                            act_eb=act_eb, w_eb=w_eb,
                                            rate=rate)
        macs = pixels * C * dot_len
    elif k in ("add", "mul", "scalar", "act", "concat", "split", "pad"):
        # element-wise / data-movement ops: TCM-bandwidth bound, fused
        # through the vector path (paired depthwise, paper §IV-A).
        elems = out_h * W * C * (2 if k in ("add", "mul") else 1)
        cyc = math.ceil(elems * act_eb / (cfg.bus_bytes * engines))
        macs = out_h * W * C
        bound = "operand-bw"
    elif k in ("maxpool", "avgpool"):
        kk = a.get("k", 2) or max(H, W)  # global -> full reduce
        elems = out_h * W * C * (kk * kk if a.get("k", 2) else 1)
        if a.get("k", 2) == 0:
            ih = g.act_inputs(op)[0].shape[0]
            iw = g.act_inputs(op)[0].shape[1]
            elems = ih * iw * C
        cyc = math.ceil(elems * act_eb / (cfg.bus_bytes * engines))
        macs = elems
        bound = "operand-bw"
    elif k == "resize":
        cyc = math.ceil(out_h * W * C * out_eb
                        / (cfg.bus_bytes * engines))
        macs = 0
        bound = "output-bw"
    elif k in ("format", "reshape"):
        cyc = math.ceil(out_bytes / cfg.tcm_bytes_per_cycle)
        macs = 0
        bound = "output-bw"
    elif k == "matmul":
        # row-wise linear over (S,1,C) tokens: fc-shaped dot engine work
        # with out_h token rows as the pixel axis
        wt = params[0]
        oc, _, _, ic = wt.shape
        pixels = out_h * W
        if fmt == "depth":
            cyc, bound = _dot_engine_cycles(cfg, pixels, C, ic, engines,
                                            weights_stationary=True,
                                            act_eb=act_eb, w_eb=w_eb,
                                            rate=rate)
        else:
            pix_e = math.ceil(out_h / engines) * W
            cyc, bound = _dot_engine_cycles(cfg, pix_e, C, ic, 1,
                                            weights_stationary=True,
                                            act_eb=act_eb, w_eb=w_eb,
                                            rate=rate)
        macs = pixels * C * ic
    elif k in ("layernorm", "softmax"):
        # per-token normalization: three vector passes over the row
        # (statistics, transform, write) through the TCM buses
        elems = out_h * W * C
        cyc = math.ceil(3 * elems * act_eb / (cfg.bus_bytes * engines))
        macs = 2 * elems
        bound = "operand-bw"
    elif k == "attention":
        # context-length-aware (arxiv 2509.25155): both GEMMs and the
        # softmax scale with the KV bucket length in op.attrs — which is
        # in the cost-memo key and the graph fingerprint, so every
        # sequence-position bucket is priced (and cached) separately.
        kv = int(a["kv_len"])
        heads, hd = int(a["heads"]), int(a["head_dim"])
        pixels = out_h * W * heads
        qk_cyc, _ = _dot_engine_cycles(cfg, pixels, kv, hd, engines,
                                       weights_stationary=False,
                                       act_eb=act_eb, w_eb=act_eb,
                                       rate=rate)
        pv_cyc, _ = _dot_engine_cycles(cfg, pixels, hd, kv, engines,
                                       weights_stationary=False,
                                       act_eb=act_eb, w_eb=act_eb,
                                       rate=rate)
        sm_cyc = math.ceil(3 * pixels * kv * 4.0
                           / (cfg.bus_bytes * engines))
        cyc = qk_cyc + pv_cyc + sm_cyc
        macs = 2 * pixels * kv * hd
        bound = "compute" if qk_cyc + pv_cyc >= sm_cyc else "operand-bw"
        # every row tile streams the whole KV cache (not an out_h slice)
        kv_bytes = sum(t.bytes for t in acts[1:3])
        q_bytes = math.ceil(acts[0].bytes * out_h / max(H, 1))
        in_bytes = q_bytes + kv_bytes
    elif k == "kvappend":
        # cache copy-through + appended rows: pure data movement
        cyc = math.ceil(out_bytes / (cfg.bus_bytes * engines))
        macs = 0
        bound = "output-bw"
    else:  # pragma: no cover
        raise NotImplementedError(k)

    # result write-back shares the third bus
    cyc = max(cyc, math.ceil(out_bytes / (cfg.bus_bytes * engines)))
    cyc += cfg.job_setup_cycles
    return JobCost(int(cyc), int(macs), int(in_bytes), int(w_bytes),
                   int(out_bytes), bound)


# --------------------------------------------------------------------------
# Data-mover cost model
# --------------------------------------------------------------------------


@lru_cache(maxsize=1 << 16)
def _dma_cost_cached(cfg: NPUConfig, nbytes: int, kind: str) -> int:
    rate = cfg.ddr_bytes_per_cycle if kind == "ddr" \
        else cfg.tcm_bytes_per_cycle
    return int(cfg.dma_setup_cycles + math.ceil(nbytes / rate))


def dma_cost(cfg: NPUConfig, nbytes: int, kind: str = "ddr") -> int:
    """Cycles for one DMA job.  kind: ddr (DDR<->TCM) or tcm (TCM<->TCM,
    used for line-format expansion copies, paper §IV-A)."""
    if nbytes <= 0:
        return 0
    if _COST_MEMO_ENABLED:
        return _dma_cost_cached(cfg, nbytes, kind)
    rate = cfg.ddr_bytes_per_cycle if kind == "ddr" \
        else cfg.tcm_bytes_per_cycle
    return int(cfg.dma_setup_cycles + math.ceil(nbytes / rate))


def cross_window_spill_cost(cfg: NPUConfig, nbytes: int,
                            round_trip: bool = True) -> int:
    """Price, in the fusion CP's bank-tick objective units, of a tile
    crossing a fusion-window boundary through DDR.

    The windowed fusion CP (:mod:`repro_torch.core.tiling`) trades "hold a
    tile resident" (``tile.banks`` per tick) against "let it go and
    bring it back from DDR" (this constant).  ``round_trip=True`` is an
    activation crossing the boundary (push + refetch);
    ``round_trip=False`` is a parameter or model input, which still
    lives in DRAM and only costs the refetch.  The exchange rate
    normalizes the DDR traffic by the DMA cost of one TCM bank, so a
    tile is worth keeping resident for roughly ``cost / banks`` ticks —
    which also makes per-window objectives comparable when they are
    summed across the stitched windows of one region."""
    if nbytes <= 0:
        return 0
    per_bank = max(1, dma_cost(cfg, cfg.bank_bytes))
    trips = 2 if round_trip else 1
    return max(1, math.ceil(trips * dma_cost(cfg, nbytes) / per_bank))


def cycles_to_ms(cfg: NPUConfig, cycles: float) -> float:
    return cycles / cfg.freq_hz * 1e3


def effective_tops(cfg: NPUConfig, macs: int, cycles: float) -> float:
    """ops/latency — the paper's 'effective TOPS' (Table I)."""
    secs = cycles / cfg.freq_hz
    return 2 * macs / secs / 1e12 if secs > 0 else 0.0
