"""``repro_torch.api``'s ``CompiledModel`` on the CPU against the JAX
package's ``repro.api``.

The same vision graphs (mobilenet_v2, resnet50_v1 at res_scale 0.25,
int8, PTQ inside ``compile``) and the same images, drawn with numpy from a
seed, go through both packages; the port replays on ``device="cpu"``,
where the plan runs K1's plain version.  Tolerances: stored integers and
the int8 interpreter's outputs exact (``array_equal``); the float32
interpreter within the reference's own ``atol`` of 1e-4 (relative to
max |output| above 1).  Both sides compile under the pinned options of
``test_torch_compile.py``, so the interpreters replay the same program.
"""
import os
import subprocess
import sys
import zipfile
from dataclasses import replace as dc_replace
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import program_cache_configure as j_cache_configure
from repro.core import program_cache_info as j_cache_info
from repro.core import serialize as jser
from repro.core.ir import GraphBuilder as JGraphBuilder
import repro_torch.api as tapi
from repro_torch.core import NEUTRON_2TOPS, ArtifactError
from repro_torch.core import program_cache_configure as t_cache_configure
from repro_torch.core import program_cache_info as t_cache_info
from repro_torch.core import serialize as tser
from repro_torch.core.executor import float_plan_tol
from repro_torch.core.ir import GraphBuilder as TGraphBuilder
from repro_torch.quant import quantize

from test_torch_compile import PINNED

ROOT = Path(__file__).resolve().parents[1]
VISION = ("mobilenet_v2", "resnet50_v1")


def _compile_pair(name, precision="int8"):
    mj = japi.compile(name, precision=precision, res_scale=0.25,
                      options=japi.CompilerOptions(**PINNED), cache=False)
    mt = tapi.compile(name, precision=precision, res_scale=0.25,
                      options=tapi.CompilerOptions(**PINNED), cache=False,
                      device="cpu")
    return mj, mt


@pytest.fixture(scope="module")
def models():
    """{name: (reference model, port model)} at int8."""
    return {name: _compile_pair(name) for name in VISION}


def _images(g, n, seed=0):
    inp = g.inputs[0]
    return np.random.default_rng(seed + 1000).normal(
        size=(n,) + inp.shape).astype(np.float32)


def _ints_equal(mj, mt, plan_j, plan_t, x, n):
    name = mt.graph.inputs[0].name
    want = plan_j.run({name: x[:n]}, n=n, decode=False)
    got = plan_t.run({name: x[:n]}, n=n, decode=False)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.int8
        assert np.array_equal(got[k].numpy(), w), (k, n)


# --------------------------------------------------------------------------
# the device plan of a compiled model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", VISION)
@pytest.mark.parametrize("n", [1, 3, 8, 5])
def test_plan_stored_ints_match_reference(models, name, n):
    """Stored ints of ``plan_for(n)`` (5 is ragged in the 8-plan)."""
    mj, mt = models[name]
    x = _images(mt.graph, 8, seed=n)
    pj, pt = mj.plan_for(n), mt.plan_for(n)
    assert pt.capacity == pj.capacity
    assert (pt.ticks, pt.ddr_bytes_per_request) == \
        (pj.ticks, pj.ddr_bytes_per_request)
    assert pt.ticks == len(mt.program.ticks) > 0
    _ints_equal(mj, mt, pj, pt, x, n)


@pytest.mark.parametrize("name", VISION)
def test_call_past_the_largest_bucket_matches_reference(models, name):
    """33 images: a 32-plan and a 1-plan.  The decoded float32 outputs
    are equal, so the stored ints are (dequantization is one-to-one for
    a given qparams), and re-quantizing gives them back."""
    mj, mt = models[name]
    x = _images(mt.graph, 33)
    want = mj(x)
    got = mt(x)
    for k, w in want.items():
        assert isinstance(got[k], torch.Tensor)
        assert got[k].device == torch.device("cpu")
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        assert np.array_equal(got[k].numpy(), w), k
        qp = mt.qm.qp(k)
        assert np.array_equal(quantize(got[k].numpy(), qp), quantize(w, qp))
    assert mt.plan_cache_info()["plan_batches"] >= 2


@pytest.mark.parametrize("name", VISION)
def test_run_many_and_unbatched_match_reference(models, name):
    mj, mt = models[name]
    x = _images(mt.graph, 5, seed=3)
    want = mj.run_many([x[i] for i in range(5)])
    got = mt.run_many([x[i] for i in range(5)])
    got_t = mt.run_many([torch.from_numpy(x[i]) for i in range(5)])
    for w, g, gt in zip(want, got, got_t):
        for k in w:
            assert np.array_equal(g[k].numpy(), w[k])
            assert torch.equal(gt[k], g[k])
    one = mt(x[0])
    for k, w in mj(x[0]).items():
        assert tuple(one[k].shape) == w.shape
        assert np.array_equal(one[k].numpy(), w)


# --------------------------------------------------------------------------
# the host interpreter
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", VISION)
def test_interp_and_check_match_reference_interpreter(models, name):
    mj, mt = models[name]
    x = _images(mt.graph, 2, seed=5)
    want = mj(x, engine="interp")
    got = mt(x, engine="interp")
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), w), k
    want = mj(x[0], check=True)
    got = mt(x[0], check=True)
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), w), k


@pytest.mark.parametrize("name", VISION)
def test_verify_passes(models, name):
    mj, mt = models[name]
    x = _images(mt.graph, 1, seed=6)[0]
    rep = mt.verify(x)
    want = mj.verify(x)
    assert rep.ok and rep.ticks == want.ticks > 0
    assert rep.ddr_bytes == want.ddr_bytes
    assert rep.max_err == want.max_err


def test_float32_model_interprets_and_plan_waits_for_item_7():
    mj, mt = _compile_pair("mobilenet_v2", precision="float32")
    assert mt.precision == "float32"
    x = _images(mt.graph, 1, seed=7)[0]
    want = mj(x, engine="interp")
    got = mt(x, engine="interp")
    for k, w in want.items():
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=tol)
    assert mt(x, check=True).keys() == want.keys()
    # the float32 plan (item 7) replays within the stated tolerance of
    # the reference's plan, and verify() holds it to the interpreter
    got = mt(x)
    for k, w in mj(x).items():
        assert float(np.abs(got[k].numpy() - w).max()) <= \
            float_plan_tol(w), k
    assert mt.plan_for(1).granularity == "op"
    assert mt.verify(x).ok


def test_report_stats_and_unported_profile(models):
    """Item 9 is done: ``profile()`` no longer raises; its modeled block
    equals the reference's (``tests/test_torch_profile.py`` holds the
    rest)."""
    mj, mt = models["mobilenet_v2"]
    mt.plan_for(8)
    rep = mt.report()
    assert f"{len(mt.program.ticks)} ticks" in rep and "on cpu" in rep
    s = mt.stats()
    assert s["ticks"] == mj.stats()["ticks"]
    assert s["precision"] == "int8"
    prof = mt.profile(batch=2, runs=1)
    assert prof.modeled == mj.profile(batch=2, runs=1).modeled
    assert prof.measured["kernels"] == len(mt.plan_for(2).steps)


# --------------------------------------------------------------------------
# artifacts: cross-loading, corruption, staleness
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", VISION)
def test_reference_artifact_loads_in_port(models, name, tmp_path):
    mj, _ = models[name]
    p = str(tmp_path / "ref.rpa")
    mj.save(p)
    lt = tapi.load(p, mmap=True, device="cpu")
    assert lt.source == p and lt.precision == "int8"
    assert lt.device == torch.device("cpu")
    x = _images(lt.graph, 8, seed=8)
    _ints_equal(mj, lt, mj.plan_for(8), lt.plan_for(8), x, 8)
    info = lt.plan_cache_info()
    assert info["consts_computed"] == 0 and info["consts_served"] > 0
    assert lt.verify(x[0]).ok


@pytest.mark.parametrize("name", VISION)
def test_port_artifact_loads_in_reference(models, name, tmp_path):
    mj, mt = models[name]
    p = str(tmp_path / "port.rpa")
    mt.save(p)
    lj = japi.load(p, mmap=True)
    x = _images(mt.graph, 8, seed=9)
    _ints_equal(mj, mt, lj.plan_for(8), mt.plan_for(8), x, 8)
    assert lj.plan_cache_info()["consts_computed"] == 0
    lt = tapi.load(p, device="cpu")
    _ints_equal(mj, mt, mj.plan_for(8), lt.plan_for(8), x, 8)
    assert lt.plan_cache_info()["consts_computed"] == 0


def test_reference_float32_artifact_interprets_in_port(tmp_path):
    g, b = _tiny_graph(JGraphBuilder)
    mj = japi.compile((g, b), cache=False)
    p = mj.save(str(tmp_path / "f.rpa"))
    lt = tapi.load(p, device="cpu")
    x = _input(g)
    want = mj(x, engine="interp")
    got = lt(x, engine="interp")
    for k, w in want.items():
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=tol)


def _tiny_graph(builder, seed: int = 0, name: str = "apitiny"):
    """The small graph of ``tests/test_api.py``, through either
    package's builder."""
    b = builder(name, seed=seed)
    x = b.input((16, 16, 8))
    x = b.conv(x, 16, k=3, act="relu")
    x = b.dwconv(x, k=3, act="relu6")
    x = b.maxpool(x, k=2)
    x = b.conv(x, 24, k=1, act="silu")
    x = b.global_avgpool(x)
    x = b.fc(x, 10)
    b.mark_output(x)
    return b.build(), b


def _input(g, seed=0):
    return np.random.default_rng(seed).normal(
        size=g.inputs[0].shape).astype(np.float32)


def _tiny_port_model():
    return tapi.compile(_tiny_graph(TGraphBuilder), precision="int8",
                        calib_samples=2, cache=False, device="cpu")


def test_artifact_corruption_rejected(tmp_path):
    p = _tiny_port_model().save(str(tmp_path / "m.rpa"))
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    with pytest.raises(ArtifactError):
        tapi.load(p, device="cpu")
    open(p, "wb").write(bytes(blob[: len(blob) // 3]))     # truncated
    with pytest.raises(ArtifactError):
        tapi.load(p, device="cpu")
    open(p, "wb").write(b"not a zip")
    with pytest.raises(ArtifactError):
        tapi.load(p, device="cpu")


def test_artifact_tampered_entry_rejected(tmp_path):
    """A re-zipped artifact with an edited payload fails the sha256
    manifest even though the zip itself is valid."""
    p = _tiny_port_model().save(str(tmp_path / "m.rpa"))
    with zipfile.ZipFile(p) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    assert b"int8" in entries["model.json"]
    entries["model.json"] = entries["model.json"].replace(b"int8", b"intX")
    with zipfile.ZipFile(p, "w") as zf:
        for n, blob in entries.items():
            zf.writestr(n, blob)
    with pytest.raises(ArtifactError):
        tapi.load(p, device="cpu")


def test_artifact_stale_for_other_graph_rejected(tmp_path):
    m = _tiny_port_model()
    p = m.save(str(tmp_path / "m.rpa"))
    other, _ = _tiny_graph(TGraphBuilder, name="other")
    with pytest.raises(ArtifactError):
        tapi.load(p, expect_graph=other, device="cpu")
    with pytest.raises(ArtifactError):
        tapi.load(p, expect_cfg=dc_replace(NEUTRON_2TOPS, tcm_banks=16),
                  device="cpu")
    with pytest.raises(ArtifactError):
        tapi.load(p, expect_options=tapi.CompilerOptions(fusion=False),
                  device="cpu")
    tapi.load(p, expect_graph=m.graph, expect_cfg=NEUTRON_2TOPS,
              expect_options=m.options, device="cpu")


# --------------------------------------------------------------------------
# the program cache's disk tier, shared by both packages
# --------------------------------------------------------------------------


#: options no other test compiles under, so the in-memory tiers miss
SHARED_OPTS = dict(partition_steps=11, parallel_cp=False)


def test_program_cache_disk_tier_shared_through_env(tmp_path):
    """The port, in a process started with ``REPRO_PROGRAM_CACHE_DIR``,
    writes the disk entry; the reference serves it from disk.  Then the
    reference writes one that the port serves."""
    code = (
        "import hashlib, json\n"
        "import repro_torch.api as api\n"
        "from repro_torch.core import serialize as s\n"
        "from repro_torch.core.ir import GraphBuilder as B\n"
        "from test_torch_api import _tiny_graph, SHARED_OPTS\n"
        "m = api.compile(_tiny_graph(B, name='shared'),\n"
        "                options=api.CompilerOptions(**SHARED_OPTS),\n"
        "                device='cpu')\n"
        "print(m.cache_tier, json.dumps(s.program_to_payload(m.program)))\n")
    env = dict(os.environ, REPRO_PROGRAM_CACHE_DIR=str(tmp_path / "a"),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tier, payload = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert tier == "None"                       # solved, then written
    assert len(list((tmp_path / "a").glob("*.rpa"))) == 1

    saved_j, saved_t = j_cache_info()["disk_dir"], t_cache_info()["disk_dir"]
    try:
        j_cache_configure(disk_dir=str(tmp_path / "a"))
        mj = japi.compile(_tiny_graph(JGraphBuilder, name="shared"),
                          options=japi.CompilerOptions(**SHARED_OPTS))
        assert mj.cache_tier == "disk"
        assert jser.program_to_payload(mj.program) == \
            __import__("json").loads(payload)

        j_cache_configure(disk_dir=str(tmp_path / "b"))
        t_cache_configure(disk_dir=str(tmp_path / "b"))
        opts = dict(SHARED_OPTS, region_overlap=5)
        mj = japi.compile(_tiny_graph(JGraphBuilder, name="shared"),
                          options=japi.CompilerOptions(**opts))
        assert mj.cache_tier is None
        mt = tapi.compile(_tiny_graph(TGraphBuilder, name="shared"),
                          options=tapi.CompilerOptions(**opts),
                          device="cpu")
        assert mt.cache_tier == "disk"
        assert tser.program_to_payload(mt.program) == \
            jser.program_to_payload(mj.program)
    finally:
        j_cache_configure(disk_dir=saved_j)
        t_cache_configure(disk_dir=saved_t)


# --------------------------------------------------------------------------
# the device contract
# --------------------------------------------------------------------------


def test_compile_and_load_raise_without_a_gpu(monkeypatch, tmp_path):
    p = _tiny_port_model().save(str(tmp_path / "m.rpa"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.compile("mobilenet_v2", precision="int8", res_scale=0.25)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.load(p)
    assert tapi.load(p, device="cpu").device == torch.device("cpu")


def test_api_exports_and_imports_no_serving_names():
    """Since item 6b the port exports the reference's Session and serving
    errors, and BreakerOpen (the port's own: a CUDA session's open breaker
    fails fast); since item 8 DecodeSession; since item 10 Fleet,
    FleetError and UpdateRejected."""
    serving = {"Session", "DecodeSession", "ServingError", "Overloaded",
               "DeadlineExceeded", "FlushError", "WorkerLost", "Ticket",
               "CircuitBreaker", "Cancelled", "FrameCorrupt", "Fleet",
               "FleetError", "UpdateRejected"}
    assert set(tapi.__all__) == {"compile", "load", "CompiledModel",
                                 "ArtifactError", "CompilerOptions",
                                 "resolve_semantics", "BreakerOpen"} | serving
    assert serving <= set(japi.__all__)
    assert issubclass(tapi.BreakerOpen, tapi.ServingError)
    assert issubclass(tapi.UpdateRejected, tapi.FleetError)
    assert issubclass(tapi.FleetError, tapi.ServingError)
