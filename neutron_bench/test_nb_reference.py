"""The reference networks against the program's float32 forward at a
small resolution, and their int8 arithmetic against the program's
quantized reference given the same qparams."""
import numpy as np
import pytest
import torch

from neutron_bench.harness import artifact, cells, data
from neutron_bench.reference import qnet

RES = 32
CONFIGS = ["resnet50_v1-int8", "mobilenet_v2-int8"]


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
def test_float_forward_matches_the_program_graph(name):
    from repro_torch.core.ir import reference_execute
    cfg, fwd, dev, specs, params, g, weights = _setup(name)
    assert len(specs) == len([op for op in g.ops
                              if op.kind in ("conv", "dwconv", "fc")])
    imgs = data.draw_images(3, 2, RES, dev)
    ref = qnet.Reference(fwd, RES, params, artifact.calib_images(cfg, dev))
    got = ref.float_logits(params, imgs).numpy()
    out = g.outputs[0].name
    want = np.stack([reference_execute(g, {g.inputs[0].name: im.numpy()},
                                       weights)[out].reshape(-1)
                     for im in imgs])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the activations neither vanish nor blow up at these weights
    assert 0.1 < np.abs(want).max() < 1e3
    assert data.macs_per_image(fwd, 224) == pytest.approx(
        {"resnet50_v1-int8": 3.87e9, "mobilenet_v2-int8": 0.30e9}[name],
        rel=0.03)


@pytest.mark.parametrize("name", CONFIGS)
def test_int8_arithmetic_equals_the_program_given_its_qparams(name):
    """With the program's own qparams, every tensor's codes equal the
    program's quantized reference: the reference's rounding is the
    deployment's.  (The benchmark's check derives its qparams itself.)"""
    from repro_torch import quant
    cfg, fwd, dev, specs, params, g, weights = _setup(name)
    calib = artifact.calib_images(cfg, dev)
    cal = [{g.inputs[0].name: im} for im in calib.numpy()]
    qm = quant.quantize_graph(g, weights, quant.calibrate(g, weights, cal))
    names = [g.inputs[0].name] + [op.outputs[0] for op in g.topo_ops()]
    theirs = [(float(np.atleast_1d(g.tensors[n].qparams.scale)[0]),
               int(np.atleast_1d(g.tensors[n].qparams.zero_point)[0]))
              for n in names]
    ref = qnet.Reference(fwd, RES, params, calib)
    assert len(ref.qparams) == len(theirs)
    for (s0, z0), (s1, z1) in zip(ref.qparams, theirs):
        assert s0 == pytest.approx(s1, rel=1e-5) and abs(z0 - z1) <= 1
    ref.qparams = theirs
    ref.qlayers = qnet.quantize_layers(specs, params, theirs,
                                       qnet.input_indices(fwd, RES))
    img = data.draw_images(4, 1, RES, dev)
    vals = quant.quantized_reference_execute(
        qm, {g.inputs[0].name: img[0].numpy()})
    codes = []

    class Rec(qnet.Net):
        def _out(self, t):
            r = super()._out(t)
            codes.append(r[0][0].permute(1, 2, 0).numpy())
            return r

    fwd(Rec("int8", qparams=ref.qparams, qlayers=ref.qlayers), img)
    for n, c in zip(names, codes):
        np.testing.assert_array_equal(c.reshape(vals[n].shape), vals[n],
                                      err_msg=n)
