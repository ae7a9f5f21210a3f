"""Integer quantization of the port: int8/int4 PTQ, the plan replay on
the device and the interpretive replay on the host.

Counterpart of ``repro/quant``.  Calibration and the PTQ pass stay on the
host in numpy (copies of ``observers``, ``qparams``, ``ptq``);
``executor.QuantSemantics`` drives both the plan replay (``execplan``),
on the device with every conv and fc on the hand-written K1 kernel, and
the interpretive replay of the compiled program on the host
(``repro_torch.core.executor``).  ``repro_torch.api.compile(name,
precision="int8")`` runs the whole flow:

    g, b = vision.build("mobilenet_v2")
    calib = quant.calibrate(g, b._weights, samples)      # observe ranges
    qm = quant.quantize_graph(g, b._weights, calib)      # annotate IR
    model = api.compile(qm)                               # compile
    model(images)                                         # plan replay

``convert.quantized_from_numpy`` carries a quantized model of the JAX
package across (qparams and integer weights as numpy arrays).
"""
from repro_torch.core.ir import QParams, graph_precision

from .executor import QuantSemantics
from .observers import (MinMaxObserver, PerChannelMinMaxObserver,
                        PercentileObserver, make_observer)
from .ptq import (QuantizedModel, calibrate, cast_graph,
                  measure_quant_error, quantize_graph,
                  quantized_reference_execute, synthetic_calibration)
from .qparams import (dequantize, dequantize_t, pack_int4,
                      qparams_from_range, qparams_per_channel, quantize,
                      quantize_t, unpack_int4)

__all__ = [
    "QParams", "QuantizedModel", "QuantSemantics",
    "MinMaxObserver", "PercentileObserver", "PerChannelMinMaxObserver",
    "make_observer", "calibrate", "quantize_graph", "cast_graph",
    "measure_quant_error", "quantized_reference_execute",
    "synthetic_calibration",
    "graph_precision",
    "quantize", "dequantize", "quantize_t", "dequantize_t",
    "qparams_from_range", "qparams_per_channel",
    "pack_int4", "unpack_int4",
]
