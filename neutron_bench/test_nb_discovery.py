"""Discovery by name, ``BENCHMARK.json`` against the files it names, the
result line's schema, and the runs that must print no result."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from neutron_bench.conftest import last_json
from neutron_bench.harness import cells

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["neutron_bench"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


CELLS = sorted(p.stem for p in (ROOT / "neutron_bench" / "workloads").glob(
    "*.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    """Every workload file resolves by name; those BENCHMARK.json lists
    report the metrics it gives them."""
    wl = cells.workload(cell)
    cfg = cells.config(wl["config"])
    assert cfg["reduced"] == []
    assert callable(cells.reference(cfg["name"]).forward)
    assert callable(cells.traffic(wl["traffic"]["kind"]).drive)
    for name in wl["end_to_end"] + wl["per_layer"]:
        assert cells.metric(name).UNIT
    entry = next((w for w in BENCH["workloads"] if w["name"] == cell), None)
    if entry is None:
        return
    assert wl["config"] == entry["config"]
    assert wl.get("chips", 1) == entry["chips"] == 1
    centry = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert centry["file"] == f"neutron_bench/configs/{cfg['name']}.json"
    assert centry["source"] == cfg["source"]
    assert centry["reduced"] == cfg["reduced"]
    for kind in ("end_to_end", "per_layer"):
        want = {m["name"] for m in BENCH[kind]
                if cell in m.get("workloads", [cell])}
        assert set(wl[kind]) == want, kind
        for m in BENCH[kind]:
            if m["name"] in wl[kind]:
                assert cells.metric(m["name"]).UNIT == m["unit"]
    # every per-layer metric's end-to-end metric is reported there too
    for m in BENCH["per_layer"]:
        if cell in m["workloads"]:
            assert m["moves"] in wl["end_to_end"]


def test_every_config_and_metric_is_used():
    cfgs = {w["config"] for w in BENCH["workloads"]}
    assert cfgs == {c["name"] for c in BENCH["configs"]}
    listed = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", listed)) <= listed


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        cells.workload("no-such-cell")
    with pytest.raises(ValueError):
        cells.metric("../run")


def test_result_line_schema(cpu_run):
    rc, out, err = cpu_run("mobilenet_v2-int8.closed-b32", seconds=1.0)
    assert rc == 0, err[-2000:]
    res = last_json(out)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"images_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    # each number compared beside its limit, last on standard error
    tail = err.strip().splitlines()[-2:]
    assert [t.split()[1] for t in tail] == list(res["checks"])
    assert all(" limit " in t for t in tail)


def test_traced_result_line(cpu_run):
    cell = "mobilenet_v2-int8.open-bursty"
    wl = dict(cells.workload(cell), traffic={
        "kind": "onoff", "period_s": 0.5, "burst_s": 0.1, "rate_on": 200.0,
        "rate_off": 20.0, "images": 64})
    rc, out, err = cpu_run(cell, seconds=1.0, trace=1, workload=wl)
    assert rc == 0, err[-2000:]
    res = last_json(out)
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in res["device"] and res["device"]["window_s"] > 0
    assert set(res["metrics"]) <= {"queue_wait_ms.open", "replay_ms.open",
                                   "device_idle.open"}
    assert "queue_wait_ms.open" in res["metrics"]


def _run_cli(cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH="")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "neutron_bench/run.py", "--workload",
         "mobilenet_v2-int8.closed-b32", "--seed", "2400000017",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_result_without_cuda():
    p = _run_cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and the files under paths
    has no program to run: no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "neutron_bench", tmp_path / "neutron_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _run_cli(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
