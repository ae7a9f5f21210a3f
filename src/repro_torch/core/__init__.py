"""The port's copy of the eIQ-Neutron compiler mid-end, and the device
plan replay engine.  Counterpart of ``repro/core``.

    ir            — graph IR, builder, reference executor
    npu           — Neutron machine model + cost functions
    cpsolver      — self-contained 0-1 CP solver
    formats       — depth/line parallelism selection (§IV-A)
    tiling        — temporal tiling + layer fusion CP (§IV-C)
    scheduling    — tick DAE scheduling CP (§IV-B)
    allocation    — banked-TCM allocation + V2P (§IV-D)
    executor      — functional banked-TCM simulator (host, numpy; the
                    validating oracle)
    serialize     — the versioned ``.rpa`` artifact container
    pipeline      — compile_graph() driver and the program cache
    execplan      — the lowered replay plan on the device

Everything but ``execplan`` is a copy of the JAX package's module of the
same name and runs on the host.
"""
from .ir import (Graph, GraphBuilder, Op, QParams, Tensor, graph_precision,
                 reference_execute)
from .npu import (ENPU_A, ENPU_B, NEUTRON_2TOPS, NPUConfig, compute_job_cost,
                  cycles_to_ms, dma_cost, effective_tops)
from .pipeline import (CompileResult, CompilerOptions, compile_graph,
                       program_cache_clear, program_cache_configure,
                       program_cache_info, program_cache_pin,
                       program_cache_unpin)
from .program import NPUProgram
from .serialize import ArtifactError

__all__ = [
    "Graph", "GraphBuilder", "Op", "QParams", "Tensor", "graph_precision",
    "reference_execute",
    "NPUConfig", "NEUTRON_2TOPS", "ENPU_A", "ENPU_B",
    "compute_job_cost", "dma_cost", "cycles_to_ms", "effective_tops",
    "CompileResult", "CompilerOptions", "compile_graph", "NPUProgram",
    "program_cache_clear", "program_cache_configure", "program_cache_info",
    "program_cache_pin", "program_cache_unpin",
    "ArtifactError",
]
