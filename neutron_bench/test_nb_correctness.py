"""``correct`` comes out false for the control and for each fault a
served cell can have, through the rest of a run on the CPU (at
resolution 32, past the harness's look for a chip); with several output
heads, each head is checked in its own steps, and a head altered,
dropped or swapped for another reads false."""
import json

import numpy as np
import pytest
import torch

from neutron_bench.conftest import last_json
from neutron_bench.harness.serve import Requests
from neutron_bench.test_nb_reference import (  # noqa: F401 (a fixture)
    TINY_DET_CELL, tiny_det)

CELL = "mobilenet_v2-int8.closed-b32"


def _gap(out):
    res = last_json(out)
    return res["correct"], res["checks"]["logit_gap_steps"]["value"]


def test_sound_run_is_correct(cpu_run):
    rc, out, err = cpu_run(CELL, seconds=0.5)
    assert rc == 0, err[-2000:]
    correct, gap = _gap(out)
    assert correct and gap <= 8


def test_control_int4_weights_is_not_correct(cpu_run):
    """The control: the program's own lower-precision path (int4
    weights, the configuration states int8)."""
    rc, out, err = cpu_run(CELL, seconds=0.5, weight_dtype="int4")
    assert rc == 0, err[-2000:]
    correct, gap = _gap(out)
    assert not correct and gap > 20


def _wrap_batches(server, change):
    model = server.model
    orig = model._run_plan_batch

    def faulty(stacked, n, owner=None):
        return change(orig, stacked, n, owner)
    model._run_plan_batch = faulty


def _misrouted(server):
    """Each answer delivered to the request after its own."""
    def change(orig, stacked, n, owner):
        return {k: torch.roll(v, 1, dims=0) if n > 1 else v + 1e3
                for k, v in orig(stacked, n, owner).items()}
    _wrap_batches(server, change)


def _half_left_out(server):
    """Only the first half of each batch computed; the rest served
    copies of it."""
    def change(orig, stacked, n, owner):
        h = (n + 1) // 2
        out = orig({k: v[:h] for k, v in stacked.items()}, h, owner)
        return {k: torch.cat([v, v[:n - h]]) for k, v in out.items()}
    _wrap_batches(server, change)


def _altered(server):
    """One logit of every answer moved where the plan produces it."""
    def change(orig, stacked, n, owner):
        out = orig(stacked, n, owner)
        return {k: v.clone().index_add_(
            -1, torch.tensor([7]), torch.full(v.shape[:-1] + (1,), 3.0))
            for k, v in out.items()}
    _wrap_batches(server, change)


@pytest.mark.parametrize("fault", [_misrouted, _half_left_out, _altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(cpu_run, fault):
    rc, out, err = cpu_run(CELL, seconds=0.5, hook=fault)
    assert rc == 0, err[-2000:]
    correct, gap = _gap(out)
    assert not correct, gap


def _info(out):
    return json.loads(out[-2])


#: the detection test network's window: long enough that the one request
#: in 24 kept for the check gives some tens of requests to compare
TINY_DET_SECONDS = 1.0


def test_every_head_is_checked_in_a_sound_run(cpu_run, tiny_det):
    """Two heads of different shapes and scales: the check reads both,
    and every request the keep mask kept is checked."""
    seed = 2_400_000_017
    rc, out, err = cpu_run(TINY_DET_CELL, seed=seed,
                           seconds=TINY_DET_SECONDS)
    assert rc == 0, err[-2000:]
    correct, gap = _gap(out)
    info = _info(out)
    assert correct and gap <= 8, (gap, info.get("check_error"))
    assert info["failed"] == 0 and info["checked"] == info["kept"] > 0
    assert info["kept"] == int(Requests(seed)._keep[:info["attempted"]].sum())


def _heads(server):
    return [t.name for t in server.model.graph.outputs]


def _second_head_altered(server):
    """One value of the second head moved where the plan produces it."""
    second = _heads(server)[1]

    def change(orig, stacked, n, owner):
        out = orig(stacked, n, owner)
        v = out[second].clone()
        v.view(n, -1)[:, 5] += 3.0
        return dict(out, **{second: v})
    _wrap_batches(server, change)


def _head_dropped(server):
    """The second head never served."""
    second = _heads(server)[1]

    def change(orig, stacked, n, owner):
        return {k: v for k, v in orig(stacked, n, owner).items()
                if k != second}
    _wrap_batches(server, change)


def _heads_swapped(server):
    """The two heads (of different shapes) served under each other's
    names."""
    first, second = _heads(server)

    def change(orig, stacked, n, owner):
        out = orig(stacked, n, owner)
        return dict(out, **{first: out[second], second: out[first]})
    _wrap_batches(server, change)


@pytest.mark.parametrize(
    "fault", [_second_head_altered, _head_dropped, _heads_swapped],
    ids=lambda f: f.__name__.strip("_"))
def test_head_fault_is_not_correct(cpu_run, tiny_det, fault):
    rc, out, err = cpu_run(TINY_DET_CELL, seconds=TINY_DET_SECONDS,
                           hook=fault)
    assert rc == 0, err[-2000:]
    correct, gap = _gap(out)
    assert not correct and gap > 12, gap
    # the fault was judged: requests compared, or the heads' mismatch named
    info = _info(out)
    assert info["checked"] > 0 or "served heads" in info["check_error"]


def test_each_head_gap_is_in_its_own_steps():
    """Two heads at scales 0.5 and 0.01, served 2 and 3 steps off: the
    request's gap is 3; a head missing or of another shape raises."""
    from types import SimpleNamespace
    from neutron_bench.harness import check
    want = [torch.arange(8, dtype=torch.float32).view(2, 4) * 0.5,
            torch.arange(6, dtype=torch.float32).view(2, 3) * 0.01]
    ref = SimpleNamespace(out_shapes=[(2, 2, 1), (1, 1, 3)],
                          out_qparams=[(0.5, 0), (0.01, 3)],
                          logits=lambda imgs: want)
    served = [[want[0][i].numpy().reshape(2, 2, 1) + 2 * 0.5,
               want[1][i].numpy().reshape(1, 1, 3) - 3 * 0.01]
              for i in range(2)]
    imgs = np.zeros((2, 4, 4, 3), np.float32)
    gaps = check.logit_gaps(ref, imgs, served, torch.device("cpu"))
    assert gaps == pytest.approx([3.0, 3.0], rel=1e-5)
    for bad in ([served[0][:1], served[1]], [served[0][::-1], served[1]]):
        with pytest.raises(ValueError, match="served heads"):
            check.logit_gaps(ref, imgs, bad, torch.device("cpu"))
