"""Launch calls on the host in the window (CUDA runtime and driver calls
that launch work: ``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaGraphLaunch`` and their kin, from torch.profiler; and one for each
kernel whose call the profiler did not see, as K1's through its own
runtime), over the window's batches (the program's ``batch`` spans)."""

UNIT = "launches"


def read(run):
    spans = run.batch_spans()
    if not spans or not run.trace.launches:
        return None
    return run.trace.launches_in_window() / len(spans)
