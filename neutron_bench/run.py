"""Run one cell of the benchmark once.

    python3 neutron_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up: the cell's compiled model (compiled and cached in the checkout by
the first run, loaded by every later one), one ``repro_torch.api.Session``
serving it, the seed's request images, and every plan bucket served
before the window.  Then the cell's traffic drives the session for
``--seconds``; with ``--trace 1`` the program's tracer and torch.profiler
are armed over the window.  After the window the outputs are collected,
the device's peak read, the session closed, and a sample of the served
outputs is held against the configuration's plain reference.

Prints, on standard output, one line of diagnostics and then the result
line (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``); on standard
error, last, each number compared beside its limit.  Exits 2 without a
result when CUDA is missing or has fewer devices than the cell asks for,
and 3 when the JAX package, JAX or flax was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np  # noqa: E402

from neutron_bench.harness import env  # noqa: E402

env.prepare()


def process_age_s() -> float:
    """Seconds since this process started (from /proc), else since this
    module started."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf("SC_CLK_TCK")
        return max(age, time.monotonic() - T_START)
    except (OSError, ValueError, IndexError):
        return time.monotonic() - T_START


AGE_AT_START = process_age_s() - (time.monotonic() - T_START)


def _gc_watch(out):
    """A ``gc.callbacks`` hook noting each full collection's ms."""
    start = []

    def watch(phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            start[:] = [time.monotonic()]
        elif start:
            out.append((time.monotonic() - start[0]) * 1e3)
    return watch


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def step_shapes(graph):
    """Plan step label -> (kind, input shape, output shape, weight shape,
    has bias) of every op of the served graph."""
    out = {}
    for op in graph.ops:
        if op.kind not in ("conv", "dwconv", "fc"):
            continue
        x = graph.act_inputs(op)[0]
        out[f"{op.name}@op"] = (
            op.kind, tuple(x.shape), tuple(graph.tensors[op.outputs[0]].shape),
            tuple(graph.tensors[op.inputs[1]].shape), len(op.inputs) > 2)
    return out


def main(argv=None, *, require_cuda=True, device=None, workload=None,
         config=None, weight_dtype="int8", pool=None, hook=None,
         check_imports=True):
    """One run; returns the exit code.  The keyword arguments serve the
    harness's own tests: a run on the CPU (``require_cuda=False``,
    ``device="cpu"``), a workload or configuration given as data, the
    program's lower-precision path (``weight_dtype``), ``hook(server)``
    to reach the program before the window, and ``check_imports=False``
    for a run inside a test process that has loaded JAX for other tests
    (a fresh process checks, as every command-line run does)."""
    args = parse(argv)
    from neutron_bench.harness import artifact, cells, check, data
    from neutron_bench.harness.run_data import Run
    from neutron_bench.harness.serve import Server
    from neutron_bench.harness.trace import Recorder

    wl = workload or cells.workload(args.workload)
    cfg = config or cells.config(wl["config"])

    import torch
    if require_cuda:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < int(wl.get("chips", 1)):
            print(f"neutron_bench: the cell needs {wl.get('chips', 1)} CUDA "
                  f"device(s), this machine has {have}", file=sys.stderr)
            return 2
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
    phases = {"imports_s": time.monotonic() - T_START}

    forward = cells.reference(cfg["name"]).forward
    t = time.monotonic()
    art = artifact.ensure(cfg, forward, dev, weight_dtype)
    phases["artifact_s"] = time.monotonic() - t
    t = time.monotonic()
    n_images = pool or int(wl["traffic"].get("images", 256))
    images = artifact.host_images(args.seed, cfg, n_images, dev)
    phases["images_s"] = time.monotonic() - t

    from repro_torch import api
    from repro_torch.kernels import neutron_matmul as k1
    t = time.monotonic()
    server = Server(api, art["path"], cfg["name"], wl["session"], images, dev,
                    args.seed)
    phases["load_s"] = time.monotonic() - t
    if hook is not None:
        hook(server)
    t = time.monotonic()
    server.warm()
    phases["warm_s"] = time.monotonic() - t
    builds0 = server.plan_builds()
    st0 = server.session.stats()["models"][cfg["name"]]
    k1_0 = k1.launches

    names = wl["per_layer"] if args.trace else wl["end_to_end"]
    readers = {n: cells.metric(n) for n in names}
    rec = Recorder() if args.trace else None
    if rec is not None:
        rec.start()
    gen = cells.traffic(wl["traffic"]["kind"])
    gc_ms = []
    gc_watch = _gc_watch(gc_ms)
    gc.callbacks.append(gc_watch)
    w0, w1 = gen.drive(server, wl["traffic"], args.seconds, args.seed)
    gc.callbacks.remove(gc_watch)
    setup_s = AGE_AT_START + (w0 - T_START)
    lost = server.collect(60.0)
    trace = rec.stop((w0, w1)) if rec is not None else None
    if cuda:
        torch.cuda.synchronize(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    builds1 = server.plan_builds()
    st1 = server.session.stats()["models"][cfg["name"]]
    k1_n = k1.launches - k1_0

    run = Run(cell=args.workload, workload=wl, config=cfg,
              seconds=w1 - w0, window=(w0, w1), setup_s=setup_s,
              requests=server.requests.arrays(),
              macs_per_image=data.macs_per_image(forward, cfg["resolution"]),
              steps=step_shapes(server.model.graph), trace=trace)
    metrics = {}
    for n, mod in readers.items():
        v = mod.read(run)
        if v is not None:
            metrics[n] = {"value": float(v), "unit": mod.UNIT}

    rq = server.requests
    arr = run.requests
    attempted = len(rq)
    failed = int(arr["failed"].sum())
    batches = st1["batches"] - st0["batches"]
    info = {
        "cell": args.workload, "seed": args.seed, "trace": args.trace,
        "artifact": art["path"].name, "compiled": art["compiled"],
        "compile_s": art["compile_s"], "setup_phases_s": phases,
        "window_s": w1 - w0, "attempted": attempted, "failed": failed,
        "errors": dict(rq.errors), "never_settled": lost,
        "completed_in_window": int(run.completed_in_window().sum()),
        "batches": batches,
        "mean_batch": (st1["batched_requests"] - st0["batched_requests"])
        / max(1, batches),
        "plan_builds_in_window": builds1 - builds0,
        "k1_launches_per_batch": k1_n / max(1, batches),
        "gc_full_collections": [len(gc_ms), sum(gc_ms),
                                max(gc_ms, default=0.0)],
    }
    done = arr["done"][run.completed_in_window()]
    info["completed_per_second"] = [
        int(((done >= w0 + k) & (done < w0 + k + 1)).sum())
        for k in range(int(w1 - w0))]
    late = arr["submitted"] - arr["due"]
    late = late[~np.isnan(late)]
    if len(late):
        info["sender_late_ms"] = {
            "p50": float(sorted(late)[len(late) // 2]) * 1e3,
            "max": float(late.max()) * 1e3}
    if trace is not None:
        calls = {}
        for t, n, _ in trace.launches:
            if w0 <= t < w1:
                calls[n] = calls.get(n, 0) + 1
        info["trace"] = {
            "clock": trace.clock, "device_events": len(trace.device),
            "untraced_kernels": len(trace.untraced()),
            "unassigned_batches": getattr(trace, "unassigned_batches", None),
            "api_calls_in_window": dict(sorted(
                calls.items(), key=lambda kv: -kv[1])[:8]),
            "spans": len(trace.spans)}

    # -- correctness, after the program's state is freed -------------------
    have = np.asarray(sorted(rq.outputs), int)
    info["kept"] = len(have)
    picked = check.sample(args.seed, have, int(wl.get("check_sample", 256)))
    names = [t.name for t in server.model.graph.outputs]
    outs = [[rq.outputs[i][n].numpy() for n in names if n in rq.outputs[i]]
            for i in picked]
    imgs = images[[rq.image[i] for i in picked]]
    server.close()
    del server, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.monotonic()
    ref = check.reference_for(cfg, forward, dev)
    try:
        gaps = check.logit_gaps(ref, imgs, outs, dev)
    except ValueError as e:                 # a head missing or misshapen
        info["check_error"] = str(e)
        print(f"neutron_bench: {e}", file=sys.stderr)
        gaps = np.zeros(0)
    info["check_s"] = time.monotonic() - t
    info["checked"] = len(gaps)
    gap = float(gaps.max()) if len(gaps) else float("inf")
    limit = float(cfg["check"]["logit_gap_steps"])
    correct = bool(len(gaps) and gap <= limit and lost == 0)

    bad = env.forbidden_loaded() if check_imports else []
    if bad:
        print(f"neutron_bench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else dev.type, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s()
        result["breakdown"] = trace.breakdown()
    result["checks"] = {"logit_gap_steps": {"value": gap, "limit": limit},
                        "never_settled": {"value": lost, "limit": 0}}
    print(json.dumps(info), flush=True)
    print(f"check logit_gap_steps {gap!r} limit {limit!r}", file=sys.stderr)
    print(f"check never_settled {lost} limit 0", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
