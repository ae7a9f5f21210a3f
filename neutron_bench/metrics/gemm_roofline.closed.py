"""The conv and fc steps' share of their roofline, in %: over every conv
and fc plan step that started in the window, the sum of each step's
least time on the H100 (the frozen K1 counts at the step's shapes and
batch size: int8 operations at 1979 TOP/s against the bytes of its input
activation, weight, bias, rescale and output, each once, at 3.35 TB/s)
over the device time of the kernels the step launched (torch.profiler,
each kernel traced to its launch call and the call to the step's span;
a kernel with no call the profiler saw given, in stream order, to the
GEMM steps of its batch).
The work is that of the steps, not of a kernel by name: a step done by
other kernels is held to the same bound."""
from neutron_bench.harness.frozen import bound_s, gemm_step_work
from neutron_bench.harness.trace import GEMM_KINDS

UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or not tr.device or not tr.launches:
        return None
    w0, w1 = tr.window
    steps = tr.plan_steps()
    gemm = [j for j, s in enumerate(steps)
            if run.steps.get(s[2], ("",))[0] in GEMM_KINDS]
    dev = tr.device_s_by_step(gemm)
    bound = busy = 0.0
    for j in gemm:
        a, b, label, n = steps[j]
        if not (w0 <= a < w1) or n <= 0:
            continue
        kind, in_shape, out_shape, wshape, bias = run.steps[label]
        flops, nbytes = gemm_step_work(kind, in_shape, out_shape, wshape, n,
                                       bias)
        bound += bound_s(nbytes, flops)[0]
        busy += dev.get(j, 0.0)
    if busy <= 0.0:
        return None
    return 100.0 * bound / busy
