"""Quantized replay semantics of the port: the plan hooks on device
tensors.

Counterpart of ``repro/quant/executor.py``.  :class:`QuantSemantics`
plugs a :class:`QuantizedModel` into the port's plan engine
(:mod:`repro_torch.core.execplan`): activations are stored int8 in the
device arena, inputs are quantized on the device, outputs decoded there.
The tolerances (one output step against the reference plan, the
calibrated band against the float oracle) are the reference's.

The interpretive replay of a compiled program (``dram_init``,
``run_step``, ``reference``) needs the compiler, which the port does not
have yet: those hooks raise ``NotImplementedError`` naming
``ROADMAP.md`` item 6.
"""
from __future__ import annotations

import numpy as np
import torch

from .ptq import QuantizedModel
from .qparams import dequantize_t, quantize_t

_INTERPRETER = ("the interpretive program replay is not ported yet "
                "(ROADMAP.md item 6: CompiledModel, compile(), the program)")


class QuantSemantics:
    """Integer execution semantics for a :class:`QuantizedModel`."""

    name = "int8"

    def __init__(self, qm: QuantizedModel, atol_steps: float = 1.5,
                 float_atol_steps: float = 4.0):
        self.qm = qm
        self.atol_steps = atol_steps          # vs the quantized oracle
        # vs the float oracle: int4 weights carry 16x the quantization
        # granularity of int8, so the calibrated band widens accordingly
        if qm.weight_dtype == "int4":
            float_atol_steps *= 16.0
        self.float_atol_steps = float_atol_steps

    # -- plan lowering hooks (repro_torch.core.execplan) --------------------
    def plan_lowerer(self):
        """One fused kernel per op; conv and fc on K1."""
        import functools

        from .execplan import lower_quant_steps
        return functools.partial(lower_quant_steps, self.qm)

    def plan_dtype(self, tensor) -> torch.dtype:
        # activations are stored int8; quantization-exempt tensors
        # (sequence-position operands) stay float32
        if tensor.qparams is None:
            return torch.float32
        return torch.int8

    def encode_input(self, name: str, arr: torch.Tensor) -> torch.Tensor:
        arr = arr.to(torch.float32)
        if self.qm.graph.tensors[name].qparams is None:
            return arr
        return quantize_t(arr, self.qm.qp(name))

    def decode(self, tensor: str, arr: torch.Tensor) -> torch.Tensor:
        return dequantize_t(arr, self.qm.qp(tensor))

    def plan_parity_tol(self, tensor: str) -> float:
        if self.qm.graph.tensors[tensor].qparams is None:
            return 1e-6
        return self._scale(tensor) + 1e-7   # one output quant step

    def tolerance(self, tensor: str, want, atol: float) -> float:
        return self.atol_steps * self._scale(tensor) + 1e-7

    # -- calibrated tolerance vs the float oracle ---------------------------
    def _scale(self, tensor: str) -> float:
        return float(np.max(np.atleast_1d(self.qm.qp(tensor).scale)))

    def float_tolerance(self, tensor: str) -> float:
        """Accepted |dequantized - float oracle| for one model output:
        2x the worst error of this PTQ on its own calibration set, with
        a floor of a few output quantization steps."""
        floor = self.float_atol_steps * self._scale(tensor) + 1e-6
        cal = self.qm.calib_error.get(tensor)
        if cal is not None and cal > 0:
            return max(floor, 2.0 * cal)
        return floor

    # -- the interpretive replay (not ported) -------------------------------
    def dram_init(self, g, inputs, weights):
        raise NotImplementedError(_INTERPRETER)

    def run_step(self, g, tiling, tcm, op, r0, r1, axis):
        raise NotImplementedError(_INTERPRETER)

    def reference(self, g, inputs, weights):
        raise NotImplementedError(_INTERPRETER)
