"""On the card: one short run of each closed cell at its full size, with
``correct`` true and the result line whole.  Skipped without a GPU."""
import io
from contextlib import redirect_stderr, redirect_stdout

import pytest

from neutron_bench.conftest import last_json


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["resnet50_v1-int8.closed-b32",
                                  "mobilenet_v2-int8.closed-b32"])
def test_closed_cell_on_the_card(card, cell):
    from neutron_bench import run
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "2400000123",
                       "--seconds", "2", "--trace", "0"], check_imports=False)
    assert rc == 0, err.getvalue()[-2000:]
    res = last_json(out.getvalue().splitlines())
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["images_s"]["value"] > 0
