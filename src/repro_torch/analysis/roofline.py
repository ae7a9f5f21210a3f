"""Roofline of a dry-run cell on the NVIDIA H100, the counterpart of
``repro/analysis/roofline.py``.

Three terms per (arch x shape x mesh), all in seconds, for one rank:

    compute    = sum over rates of operations / the card's peak at that rate
    memory     = bytes moved / HBM bandwidth
    collective = bytes on the wire / link bandwidth

The counts are those of the step the rank runs (``analysis.cost``); the
wire bytes follow the reference's ring model (``analysis.cost.ring_wire``).

The constants are one NVIDIA H100 SXM5 80GB (HBM3) at its 700 W power
limit, from NVIDIA's data sheet (dense rates, no sparsity): HBM3 3.35e12
B/s; bf16 989e12, int8 1979e12, TF32 495e12 and float32 (outside the
tensor cores) 67e12 operations a second.  A card set below 700 W runs
slower under load.  The link term takes one GPU's InfiniBand NDR port,
400 Gb/s = 50e9 B/s in each direction: both axes of the production mesh
span 16 ranks, more than the 8 GPUs of one NVLink domain, so a ring over
either axis crosses the network.  ``bound`` is the same model for one
kernel call, the ``bound_ms`` column of ``chip_smoke.py``'s kernel table.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

#: H100 SXM5 80GB HBM3 memory bandwidth, bytes a second
HBM_BYTES_S = 3.35e12
#: H100 SXM5 dense peak operations a second, by the rate of the operands
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "int8": 1979e12,      # dense tensor-core rate (K1's bound)
              "tf32": 495e12,       # dense tensor-core rate (3xTF32 issues
                                    # three products for each one)
              "float32": 67e12}     # outside the tensor cores
#: one H100's InfiniBand NDR port (400 Gb/s), bytes a second each way
LINK_BYTES_S = 50e9


def compute_seconds(flops: Dict[str, float]) -> float:
    """Seconds to do {rate: operations} at the H100's peak rates."""
    return sum(f / PEAK_FLOPS[r] for r, f in flops.items())


def bound(nbytes: float, flops, dtype: Optional[str] = None
          ) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the time to move
    `nbytes` through HBM and to do `flops` operations at `dtype`'s rate;
    without `dtype`, `flops` is {rate: operations} for work done at
    several rates."""
    work = {dtype: flops} if dtype else flops
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = compute_seconds(work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float                 # 6·N·D (or 6·N_active·D)
    useful_ratio: float                # MODEL_FLOPS / (FLOPs·chips)
    peak_fraction: float               # t_compute / max(all terms)
    collectives: Dict[str, int] = field(default_factory=dict)
    memory_per_chip_gb: float = 0.0
    note: str = ""
    flops_by_rate: Dict[str, float] = field(default_factory=dict)

    @property
    def bound_s(self) -> float:
        """The roofline's least time for the step: its largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_json(self) -> Dict:
        return asdict(self)


def build_roofline(arch: str, shape: str, mesh_name: str, chips: int,
                   flops_per_chip: float, bytes_per_chip: float,
                   wire_bytes_per_chip: float, model_flops: float,
                   collectives: Optional[Dict[str, float]] = None,
                   memory_per_chip: float = 0.0, note: str = "",
                   flops_by_rate: Optional[Dict[str, float]] = None
                   ) -> Roofline:
    """The reference's three terms with the H100's constants.
    `flops_by_rate` ({rate: operations}, summing to `flops_per_chip`)
    times each rate's work at its own peak; without it every operation
    counts at the bf16 rate."""
    by_rate = dict(flops_by_rate or {"bfloat16": flops_per_chip})
    t_c = compute_seconds(by_rate)
    t_m = bytes_per_chip / HBM_BYTES_S
    t_x = wire_bytes_per_chip / LINK_BYTES_S
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    dom = max(t_c, t_m, t_x)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops_per_chip, bytes_per_chip=bytes_per_chip,
        wire_bytes_per_chip=wire_bytes_per_chip,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops_per_chip * chips)
                      if flops_per_chip > 0 else 0.0),
        peak_fraction=(t_c / dom if dom > 0 else 0.0),
        collectives={k: int(v) for k, v in (collectives or {}).items()},
        memory_per_chip_gb=memory_per_chip / 1e9,
        note=note, flops_by_rate=by_rate,
    )


def model_flops_for(arch_cfg, shape_spec) -> float:
    """6·N·D training FLOPs (dense) / 6·N_active·D (MoE); forward-only
    (2·N·D) for prefill; per-token (2·N_active) for decode."""
    n = active_params(arch_cfg)
    if shape_spec.kind == "train":
        return 6.0 * n * shape_spec.global_batch * shape_spec.seq_len
    if shape_spec.kind == "prefill":
        return 2.0 * n * shape_spec.global_batch * shape_spec.seq_len
    return 2.0 * n * shape_spec.global_batch        # one token per stream


def active_params(cfg) -> float:
    """Parameters touched per token (MoE: shared + top_k experts)."""
    total = cfg.n_params()
    if not cfg.n_experts:
        return float(total)
    fe = cfg.moe_d_ff or cfg.d_ff
    mult = 3 if cfg.gated_mlp else 2
    n_moe_layers = cfg.n_layers - cfg.moe_layer_start
    all_experts = cfg.n_experts * mult * cfg.d_model * fe * n_moe_layers
    active_experts = cfg.top_k * mult * cfg.d_model * fe * n_moe_layers
    return float(total - all_experts + active_experts)


def format_table(rows: List[Roofline]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':9s} "
           f"{'t_comp(ms)':>10s} {'t_mem(ms)':>10s} {'t_coll(ms)':>10s} "
           f"{'bound':>10s} {'useful':>7s} {'roofl%':>7s} {'HBM(GB)':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:9s} "
            f"{r.t_compute*1e3:10.3f} {r.t_memory*1e3:10.3f} "
            f"{r.t_collective*1e3:10.3f} {r.bottleneck:>10s} "
            f"{r.useful_ratio:7.3f} {r.peak_fraction*100:6.1f}% "
            f"{r.memory_per_chip_gb:8.2f}")
    return "\n".join(lines)
