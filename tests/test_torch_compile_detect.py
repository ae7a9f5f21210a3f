"""The port's compiler against the JAX package's on the detection graphs
of the vision suite (int8, res_scale 0.25, options pinned): equal ticks
and DDR bytes, equal payloads and byte-equal ``.rpa`` artifacts.  The
checks, the pinned options and the expected table are those of
``test_torch_compile.py``; the graphs are split over the two files so
that each stays near 50 s on one worker."""
import pytest

from test_torch_compile import (check_payloads, check_rpa_bytes,
                                check_ticks_and_ddr_bytes, compiled)

GRAPHS = ("efficientdet_lite0", "yolov8n_det", "yolov8n_seg",
          "mobilenet_v1_ssd", "mobilenet_v2_ssd", "damo_yolo_nl")

__all__ = ["compiled"]


@pytest.mark.parametrize("name", GRAPHS)
def test_ticks_and_ddr_bytes_match_reference(compiled, name):
    check_ticks_and_ddr_bytes(compiled, name)


@pytest.mark.parametrize("name", GRAPHS)
def test_payloads_match_reference(compiled, name):
    check_payloads(compiled, name)


@pytest.mark.parametrize("name", GRAPHS)
def test_rpa_bytes_match_reference(compiled, name):
    check_rpa_bytes(compiled, name)
