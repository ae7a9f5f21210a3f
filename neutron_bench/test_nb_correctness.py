"""``correct`` comes out false for the control and for each fault a
served cell can have, through the rest of a run on the CPU (at
resolution 32, past the harness's look for a chip)."""
import pytest
import torch

from neutron_bench.conftest import last_json

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
