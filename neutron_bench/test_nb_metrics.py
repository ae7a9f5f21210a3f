"""The metric arithmetic on synthetic runs and traces, and the frozen work
counts against the program's own."""
import numpy as np
import pytest

from neutron_bench.harness import cells, frozen
from neutron_bench.harness.run_data import Run
from neutron_bench.harness.trace import Trace, quantile


def _run(due, done, failed=None, window=(100.0, 110.0), trace=None,
         steps=None):
    due, done = np.asarray(due, float), np.asarray(done, float)
    failed = np.zeros(len(due), bool) if failed is None \
        else np.asarray(failed, bool)
    return Run(cell="c", workload={}, config={}, seconds=window[1] - window[0],
               window=window, setup_s=7.5,
               requests={"due": due, "submitted": due, "done": done,
                         "failed": failed},
               macs_per_image=1000, steps=steps or {}, trace=trace)


def read(name, run):
    return cells.metric(name).read(run)


def test_rate_is_over_the_whole_window():
    # 6 settle inside [100, 110], one after, one failed inside
    done = [100.5, 101, 103, 105, 109, 110.0, 111, 104]
    run = _run(due=[100] * 8, done=done,
               failed=[0, 0, 0, 0, 0, 0, 0, 1])
    assert read("images_s", run) == pytest.approx(6 / 10.0)
    assert read("setup_s", run) == 7.5


def test_tail_over_all_requests_from_due_time():
    rng = np.random.default_rng(0)
    due = 100 + np.sort(rng.uniform(0, 10, 1000))
    lat = rng.exponential(0.02, 1000)
    failed = np.zeros(1000, bool)
    failed[::50] = True                       # 20 failed: not in the tail
    run = _run(due, due + lat, failed)
    kept = np.sort(lat[~failed])
    n = len(kept)
    assert read("latency_p50_ms", run) == pytest.approx(
        kept[int(np.ceil(0.5 * n)) - 1] * 1e3)
    assert read("latency_p95_ms", run) == pytest.approx(
        kept[int(np.ceil(0.95 * n)) - 1] * 1e3)
    # a request due after the window is not in the window's tail
    late = _run(np.append(due, 111.0), np.append(due + lat, 200.0),
                np.append(failed, False))
    assert read("latency_p95_ms", late) == read("latency_p95_ms", run)


def test_quantile_nearest_rank():
    assert quantile([5, 1, 3, 2, 4], 0.5) == 3
    assert quantile(range(1, 101), 0.95) == 95
    assert quantile([7.0], 0.95) == 7.0


def _trace():
    tr = Trace(window=(0.0, 1.0))
    # device: [0.1, 0.3] and [0.2, 0.4] overlap, [0.9, 1.2] crosses the end
    tr.device = [(0.1, 0.3, "k1", 1), (0.2, 0.4, "k2", 2),
                 (0.9, 1.2, "copy", 3), (-0.5, -0.1, "before", 4)]
    tr.launches = [(0.05, "cudaLaunchKernel", 1),
                   (0.15, "cuLaunchKernel", 2),
                   (0.85, "cudaLaunchKernel", 3),
                   (1.5, "cudaLaunchKernel", 9)]
    # one batch of 32 holding a conv step (launches 1, 2) and a dwconv
    tr.spans = [("batch", "serving", 0.0, 0.8, 1, {"n": 32}),
                ("conv_3@op", "plan", 0.01, 0.2, 1, None),
                ("dwconv_4@op", "plan", 0.8, 0.9, 1, None),
                ("queue_wait", "async:serving", 0.0, 0.004, 1, None),
                ("queue_wait", "async:serving", 0.5, 0.510, 1, None),
                ("queue_wait", "async:serving", 0.6, 0.602, 1, None),
                ("queue_wait", "async:serving", 1.5, 1.9, 1, None)]
    return tr


def test_idle_share_of_a_synthetic_trace():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(0.3 + 0.1)
    run = _run([0.0], [0.5], window=(0.0, 1.0), trace=tr)
    assert read("device_idle.closed", run) == pytest.approx(60.0)
    assert read("device_idle.open", run) == pytest.approx(60.0)
    gaps = tr.gaps()
    assert gaps[0] == (0.0, 0.1) and gaps[-1] == pytest.approx((0.4, 0.9))
    bd = tr.breakdown()
    assert dict(bd["device_ops"])["k1"] == pytest.approx(0.2)
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(0.6)


def test_span_readers():
    tr = _trace()
    run = _run([0.0], [0.5], window=(0.0, 1.0), trace=tr)
    assert read("queue_wait_ms.open", run) == pytest.approx(4.0)
    assert read("replay_ms.closed", run) == pytest.approx(800.0)
    assert read("replay_ms.open", run) == pytest.approx(800.0)
    assert read("launches_per_replay.closed", run) == pytest.approx(3.0)
    assert read("replay_ms.closed", _run([0.0], [0.5])) is None


@pytest.mark.parametrize("shapes", [
    ((224, 224, 3), (112, 112, 64), (64, 7, 7, 3)),      # resnet stem
    ((56, 56, 64), (56, 56, 64), (64, 3, 3, 64)),
    ((7, 7, 320), (7, 7, 1280), (1280, 1, 1, 320)),
    ((1, 1, 2048), (1, 1, 1000), (1000, 1, 1, 2048)),   # fc
])
@pytest.mark.parametrize("batch", [1, 32])
def test_gemm_bound_equals_the_frozen_program_counts(shapes, batch):
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.kernels import work

    x, y, w = shapes
    flops, nbytes = frozen.gemm_step_work("conv", x, y, w, batch)
    rows = batch * y[0] * y[1]
    k = w[1] * w[2] * w[3]
    assert flops == work.matmul_flops(rows, w[0], k, torch.int8)
    t = lambda s: torch.empty(s, dtype=torch.int8, device="meta")  # noqa
    want = work.nbytes(t((batch,) + x), t((w[0], k)),
                       torch.empty((w[0],), dtype=torch.int32, device="meta"),
                       torch.empty((w[0],), dtype=torch.float32,
                                   device="meta"),
                       t((batch,) + y))
    assert nbytes == want
    ms, by = roofline.bound(nbytes, flops)
    s, by2 = frozen.bound_s(nbytes, flops)
    assert s * 1e3 == pytest.approx(ms) and by == by2
    assert frozen.PEAK_FLOPS == roofline.PEAK_FLOPS
    assert frozen.HBM_BYTES_S == roofline.HBM_BYTES_S


def test_gemm_roofline_reader():
    tr = _trace()
    steps = {"conv_3@op": ("conv", (8, 8, 16), (8, 8, 32), (32, 3, 3, 16),
                           True),
             "dwconv_4@op": ("dwconv", (8, 8, 32), (8, 8, 32), (32, 3, 3, 1),
                             True)}
    run = _run([0.0], [0.5], window=(0.0, 1.0), trace=tr, steps=steps)
    flops, nbytes = frozen.gemm_step_work("conv", (8, 8, 16), (8, 8, 32),
                                          (32, 3, 3, 16), 32)
    bound = frozen.bound_s(nbytes, flops)[0]
    # the conv step launched k1 (0.2 s) and k2 (0.2 s); the dwconv is not
    # a GEMM step
    assert read("gemm_roofline.closed", run) == pytest.approx(
        100 * bound / 0.4)


def test_mfu():
    run = _run([100] * 4, [101, 102, 103, 120], trace=Trace(window=(100,
                                                                    110)))
    assert read("mfu.closed", run) == pytest.approx(
        100 * 2 * 1000 * 3 / 10.0 / 1979e12)


def test_untraced_kernels_go_to_the_gemm_steps_in_order():
    """K1's kernels come with no host call the profiler saw: in stream
    order they go to the GEMM steps of their batch, and count as one
    launch each."""
    tr = Trace(window=(0.0, 1.0))
    tr.spans = [("batch", "serving", 0.0, 0.5, 1, {"n": 8}),
                ("conv_1@op", "plan", 0.01, 0.02, 1, None),
                ("add_2@op", "plan", 0.02, 0.03, 1, None),
                ("conv_3@op", "plan", 0.03, 0.04, 1, None),
                ("fc_4@op", "plan", 0.04, 0.05, 1, None)]
    tr.launches = [(0.025, "cudaLaunchKernel", 10)]          # the add's
    tr.device = [(0.10, 0.11, "gemm", 0), (0.11, 0.12, "add", 10),
                 (0.12, 0.15, "gemm", 0), (0.15, 0.19, "gemm", 0),
                 (0.20, 0.21, "Memcpy DtoH", 0)]
    by_step = tr.device_s_by_step(gemm=[0, 2, 3])
    assert by_step[0] == pytest.approx(0.01)
    assert by_step[1] == pytest.approx(0.01)
    assert by_step[2] == pytest.approx(0.03)
    assert by_step[3] == pytest.approx(0.04)
    assert tr.launches_in_window() == 4
    assert tr.unassigned_batches == 0
