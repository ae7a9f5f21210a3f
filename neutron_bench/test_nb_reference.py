"""The reference networks against the program's float32 forward at a
small resolution, and their int8 arithmetic against the program's
quantized reference given the same qparams.

Beside the benchmark's configurations, a small detection-shaped network
(``nb_tinydet``), written twice below, once for the program's graph
builder and once for :mod:`neutron_bench.reference.qnet`: a 3x3/2 SiLU
stem, a C2f-like block (1x1, split in two, two 3x3 SiLU convs, add,
concat, 1x1), an SPPF-like chain of three 5x5/1 max pools concatenated,
a x2 nearest upsampling concatenated with a skip, and two 1x1 heads at
two scales.  The :func:`tiny_det` fixture registers it with the
program's vision frontend and the harness's look-ups, in the test only.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neutron_bench.harness import artifact, cells, data
from neutron_bench.reference import qnet

RES = 32
TINY_DET = "nb_tinydet-int8"
TINY_DET_CELL = "nb_tinydet-int8.closed-b8"
CONFIGS = ["resnet50_v1-int8", "mobilenet_v2-int8", TINY_DET]


def tiny_det_graph(res):
    from repro_torch.core.ir import GraphBuilder
    b = GraphBuilder("nb_tinydet")
    x = b.input((res, res, 3))
    x = b.conv(x, 16, k=3, s=2, act="silu")
    y = b.conv(x, 16, k=1, act="silu")
    a, c = b.split(y, 2)
    z = b.conv(c, 8, k=3, act="silu")
    z = b.conv(z, 8, k=3, act="silu")
    z = b.add(c, z)
    hi = b.conv(b.concat([a, c, z]), 16, k=1, act="silu")
    x = b.conv(hi, 32, k=3, s=2, act="silu")
    y = b.conv(x, 16, k=1, act="silu")
    p1 = b.maxpool(y, k=5, s=1, pad="same")
    p2 = b.maxpool(p1, k=5, s=1, pad="same")
    p3 = b.maxpool(p2, k=5, s=1, pad="same")
    lo = b.conv(b.concat([y, p1, p2, p3]), 32, k=1, act="silu")
    m = b.conv(b.concat([b.resize(lo, 2), hi]), 16, k=3, act="silu")
    b.mark_output(b.conv(m, 12, k=1))
    b.mark_output(b.conv(lo, 20, k=1))
    return b.build(), b


def tiny_det_forward(net, images):
    x = net.input(images)
    x = net.conv(x, 16, k=3, s=2, act="silu")
    y = net.conv(x, 16, act="silu")
    a, c = net.split(y, 2)
    z = net.conv(c, 8, k=3, act="silu")
    z = net.conv(z, 8, k=3, act="silu")
    z = net.add(c, z)
    hi = net.conv(net.concat([a, c, z]), 16, act="silu")
    x = net.conv(hi, 32, k=3, s=2, act="silu")
    y = net.conv(x, 16, act="silu")
    p1 = net.maxpool(y, k=5, s=1)
    p2 = net.maxpool(p1, k=5, s=1)
    p3 = net.maxpool(p2, k=5, s=1)
    lo = net.conv(net.concat([y, p1, p2, p3]), 32, act="silu")
    m = net.conv(net.concat([net.resize(lo, 2), hi]), 16, k=3, act="silu")
    return [net.conv(m, 12), net.conv(lo, 20)]


TINY_DET_CONFIG = {
    "name": TINY_DET, "model": "nb_tinydet", "resolution": RES,
    "precision": "int8", "weight_seed": 0, "calib_images": 4,
    "check": {"logit_gap_steps": 12.0}}
TINY_DET_WORKLOAD = {
    "config": TINY_DET, "chips": 1,
    "traffic": {"kind": "closed", "clients": 2, "requests_per_round": 8,
                "images": 64},
    "session": {"max_batch": 8, "workers": 1, "linger_ms": 2.0,
                "max_queue": 64},
    "end_to_end": ["images_s", "setup_s"], "per_layer": [],
    "check_sample": 256}


@pytest.fixture
def tiny_det(monkeypatch):
    """``nb_tinydet`` in the program's ``vision.VISION_MODELS`` and the
    harness's configuration, workload and reference look-ups."""
    from repro_torch.frontends import vision
    monkeypatch.setitem(vision.VISION_MODELS, "nb_tinydet",
                        (tiny_det_graph, RES, 0.0, 0.0))
    for fn, name, value in (
            ("config", TINY_DET, TINY_DET_CONFIG),
            ("workload", TINY_DET_CELL, TINY_DET_WORKLOAD),
            ("reference", TINY_DET, SimpleNamespace(
                forward=tiny_det_forward))):
        def look(n, orig=getattr(cells, fn), name=name, value=value):
            return value if n == name else orig(n)
        monkeypatch.setattr(cells, fn, look)


def _setup(name):
    torch.set_num_threads(2)
    cfg = dict(cells.config(name), resolution=RES)
    fwd = cells.reference(name).forward
    dev = torch.device("cpu")
    specs, params = artifact.params_for(cfg, fwd, dev)
    g = artifact.graph_of(cfg)
    weights = data.bind_params(g, params, specs)
    return cfg, fwd, dev, specs, params, g, weights


@pytest.mark.parametrize("name", CONFIGS)
def test_float_forward_matches_the_program_graph(name, tiny_det):
    from repro_torch.core.ir import reference_execute
    cfg, fwd, dev, specs, params, g, weights = _setup(name)
    weighted = [op for op in g.ops if op.kind in ("conv", "dwconv", "fc")]
    assert len(specs) == len(weighted)
    imgs = data.draw_images(3, 2, RES, dev)
    ref = qnet.Reference(fwd, RES, params, artifact.calib_images(cfg, dev))
    got = ref.float_logits(params, imgs)
    assert len(got) == len(g.outputs)
    vals = [reference_execute(g, {g.inputs[0].name: im.numpy()}, weights)
            for im in imgs]
    for head, out in zip(got, g.outputs):
        want = np.stack([v[out.name].reshape(-1) for v in vals])
        assert np.abs(head.numpy() - want).max() \
            <= 1e-5 * np.abs(want).max(), out.name
        # the activations neither vanish nor blow up at these weights
        assert 0.1 < np.abs(want).max() < 1e3, out.name
    assert ref.out_shapes == [tuple(o.shape) for o in g.outputs]
    assert data.macs_per_image(fwd, RES) == sum(g.op_macs(op)
                                                for op in weighted)
    if name != TINY_DET:
        assert data.macs_per_image(fwd, 224) == pytest.approx(
            {"resnet50_v1-int8": 3.87e9, "mobilenet_v2-int8": 0.30e9}[name],
            rel=0.03)


@pytest.mark.parametrize("name", CONFIGS)
def test_int8_arithmetic_equals_the_program_given_its_qparams(name, tiny_det):
    """With the program's own qparams, every tensor's codes equal the
    program's quantized reference: the reference's rounding is the
    deployment's.  Each op reads the program's codes of its inputs, so a
    code that rounds apart shows at the op that rounds it; only a SiLU
    output may, where a value lies at a rounding boundary, and then by
    one step.  The decoded outputs of a network without SiLU equal the
    program's bit for bit.  (The benchmark's check derives its qparams
    itself.)"""
    from repro_torch import quant
    cfg, fwd, dev, specs, params, g, weights = _setup(name)
    calib = artifact.calib_images(cfg, dev)
    cal = [{g.inputs[0].name: im} for im in calib.numpy()]
    qm = quant.quantize_graph(g, weights, quant.calibrate(g, weights, cal))
    names = [g.inputs[0].name] + [o for op in g.topo_ops()
                                  for o in op.outputs]
    silu = {op.outputs[0] for op in g.ops if op.attrs.get("act") == "silu"}
    theirs = [(float(np.atleast_1d(g.tensors[n].qparams.scale)[0]),
               int(np.atleast_1d(g.tensors[n].qparams.zero_point)[0]))
              for n in names]
    ref = qnet.Reference(fwd, RES, params, calib)
    assert len(ref.qparams) == len(theirs)
    for (s0, z0), (s1, z1) in zip(ref.qparams, theirs):
        assert s0 == pytest.approx(s1, rel=1e-5) and abs(z0 - z1) <= 1
    ref.qparams = theirs
    ref.qlayers = qnet.quantize_layers(specs, params, theirs, ref.input_of)
    img = data.draw_images(4, 1, RES, dev)
    vals = quant.quantized_reference_execute(
        qm, {g.inputs[0].name: img[0].numpy()})
    apart = {}

    class Fed(qnet.Net):
        """Each tensor's codes compared, then the program's passed on."""

        def _out(self, t):
            n = names[self._ti]
            q, qp = super()._out(t)
            want = torch.from_numpy(vals[n].astype(np.int32)).reshape(
                q.shape[2], q.shape[3], q.shape[1]).permute(2, 0, 1)[None]
            diff = (q - want).abs()
            if int(diff.max()):
                apart[n] = (int(diff.max()), int((diff > 0).sum()))
            return want, qp

    fwd(Fed("int8", qparams=ref.qparams, qlayers=ref.qlayers), img)
    assert set(apart) <= silu, {n: apart[n] for n in set(apart) - silu}
    assert all(most == 1 for most, _ in apart.values()), apart
    n_silu = sum(vals[n].size for n in silu)
    assert sum(k for _, k in apart.values()) <= max(1, n_silu // 1000), \
        (apart, n_silu)
    if not silu:
        got = ref.logits(img)
        for head, out in zip(got, g.outputs):
            want = qnet.dequantize(torch.from_numpy(
                vals[out.name].astype(np.int32)).reshape(1, -1),
                theirs[names.index(out.name)])
            assert torch.equal(head, want), out.name


@pytest.mark.parametrize("act", ["relu", "relu6", "silu"])
def test_gain_keeps_unit_variance(act):
    """``GAIN[act] * E[f(z)^2] = 1`` for a unit normal z: a layer drawn
    with that gain passes unit variance on (He et al. 2015)."""
    z = torch.linspace(-12, 12, 480_001, dtype=torch.float64)
    phi = torch.exp(-z * z / 2) / np.sqrt(2 * np.pi)
    f = qnet.activation(z, act)
    second_moment = torch.trapezoid(f * f * phi, z).item()
    assert data.GAIN[act] * second_moment == pytest.approx(1, rel=1e-5)


def test_artifact_key_follows_the_weight_sources(tmp_path, monkeypatch):
    """The cached artifact's key changes with the reference network and
    with the sources that draw the weights, so a checkout never serves an
    artifact compiled from other weights than the reference is given."""
    cfg = cells.config("resnet50_v1-int8")
    fwd = cells.reference("resnet50_v1-int8").forward
    cpu = torch.device("cpu")
    k = artifact.key(cfg, fwd, "int8", cpu)
    assert k == artifact.key(cfg, fwd, "int8", cpu)
    assert k != artifact.key(
        cfg, cells.reference("mobilenet_v2-int8").forward, "int8", cpu)
    edited = tmp_path / "data.py"
    edited.write_text(open(data.__file__).read() + "\n# edited\n")
    monkeypatch.setattr(data, "__file__", str(edited))
    assert k != artifact.key(cfg, fwd, "int8", cpu)
