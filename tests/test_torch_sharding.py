"""The port's sharding rules (``repro_torch.models.sharding``,
``models.registry``'s specs, ``launch.mesh``, ``runtime.overlap``'s
``bucket_tree`` / ``overlap_flags`` and ``ops.combine_decode_shards``)
against the JAX package's, on the CPU, without a process group.

Specs are compared for every leaf of every zoo arch, reduced and at full
width, from abstract shapes: the reference's ``jax.eval_shape`` of its
``init_params`` / ``init_cache`` against the port's LM and caches on the
meta device (laid out as the reference's tree by
``models.convert.reference_leaves``).  A spec is the reference's
PartitionSpec as a tuple.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models import sharding as jsh
from repro.runtime import overlap as joverlap
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models import sharding as tsh
from repro_torch.models.convert import reference_leaves
from repro_torch.runtime import overlap as toverlap

ARCHS = jreg.ARCH_IDS
CACHE_SHAPES = ("decode_32k", "long_500k")


def _key_str(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)


def _ref_flat(tree):
    """{path: leaf} of a reference tree of specs or shapes (PartitionSpec
    leaves kept whole, None subtrees dropped)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(_key_str(k) for k in path): leaf for path, leaf in flat}


def _port_flat(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_port_flat(tree[k], prefix + (k,)))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(_port_flat(getattr(tree, f), prefix + (f,)))
    elif tree is not None:
        out[prefix] = tree
    return out


def _nest(flat):
    tree = {}
    for path, leaf in flat.items():
        sub = tree
        for k in path[:-1]:
            sub = sub.setdefault(k, {})
        sub[path[-1]] = leaf
    return tree


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _cfgs(arch):
    j, t = jreg.get_arch(arch), treg.get_arch(arch)
    return [(j, t), (j.reduced(), t.reduced())]


def _port_params(cfg):
    """The port's parameters as the reference's tree of shapes (meta)."""
    model = tlm.LM(cfg, torch.device("meta"), mtp=True)
    return _nest({path: _Shape((*lead, *ts[0].shape))
                  for path, lead, ts in reference_leaves(cfg, model)})


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference_for_every_leaf(arch):
    """param_spec / tree_partition_specs (both with and without the
    replicate options), state_specs and cache_specs of every leaf, at
    full width and reduced, equal the reference's."""
    for jcfg, tcfg in _cfgs(arch):
        ja = jax.eval_shape(partial(jlm.init_params, jcfg),
                            jax.random.PRNGKey(0))
        ta = _port_params(tcfg)
        jshapes = {p: tuple(s.shape) for p, s in _ref_flat(ja).items()}
        tshapes = {p: s.shape for p, s in _port_flat(ta).items()}
        assert tshapes == jshapes, tcfg.name
        for kw in ({}, {"replicate_kv": True, "replicate_q": True},
                   {"fsdp_axis": "data"}):
            want = _ref_flat(jsh.tree_partition_specs(ja, **kw))
            got = _port_flat(tsh.tree_partition_specs(ta, **kw))
            assert got == {p: _spec(s) for p, s in want.items()}, \
                (tcfg.name, kw)
        want = _ref_flat(jreg.state_specs(jcfg, ja))
        got = _port_flat(treg.state_specs(tcfg, ta))
        assert got == {p: _spec(s) for p, s in want.items()}, tcfg.name
        for path, shape in tshapes.items():
            ps = "/".join(path)
            assert tsh.param_spec(ps, shape) == _spec(
                jsh.param_spec(ps, shape))
        for shape in CACHE_SHAPES:
            ss = jreg.SHAPES[shape]
            batch, max_len = min(ss.global_batch, 16), 256
            jc = jreg.abstract_cache(jcfg, batch, max_len)
            tc = tlm.init_cache(tcfg, batch, max_len, device="meta")
            assert {p: tuple(s.shape) for p, s in _port_flat(tc).items()} \
                == {p: tuple(s.shape) for p, s in _ref_flat(jc).items()}
            want = _ref_flat(jreg.cache_specs(jcfg, jc, shape))
            got = _port_flat(treg.cache_specs(tcfg, tc, shape))
            assert got == {p: _spec(s) for p, s in want.items()}, \
                (tcfg.name, shape)


@pytest.mark.parametrize("shape,with_pod", [((7, 48), False),
                                            ((32, 50280), True),
                                            ((2, 16, 48), True)])
def test_enforce_divisible_and_batch_spec_equal_the_reference(shape,
                                                              with_pod):
    for spec in ((("pod", "data"), "model"), ("data", None),
                 (None, "model", "data")):
        spec = spec[:len(shape)] + (None,) * (len(shape) - len(spec))
        assert tsh.enforce_divisible(spec, shape) == _spec(
            jsh.enforce_divisible(jax.sharding.PartitionSpec(*spec), shape))
    assert tsh.DEFAULT_AXIS_SIZES == jsh.DEFAULT_AXIS_SIZES
    for kind in ("train", "prefill", "decode"):
        want = jreg.batch_spec(kind, with_pod)
        got = treg.batch_spec(kind, with_pod)
        if isinstance(want, dict):
            assert got == {k: _spec(v) for k, v in want.items()}
        else:
            assert got == _spec(want)
    assert treg.SHAPES == {k: treg.ShapeSpec(*(getattr(v, f) for f in (
        "name", "seq_len", "global_batch", "kind")))
        for k, v in jreg.SHAPES.items()}


REF_MESH = dict(flops_per_chip=197e12, hbm_gbps=819e9, ici_gbps=50e9)


@pytest.mark.parametrize("n_data,n_model", [(16, 16), (1, 8), (4, 2)])
def test_format_planner_chooses_as_the_reference(n_data, n_model):
    """Depth or line for a grid of block shapes, with the reference's
    MeshSpec rates passed in: the same choice and the same modeled
    latencies."""
    jp = jsh.FormatPlanner(jsh.MeshSpec(n_data, n_model, **REF_MESH))
    tp = tsh.FormatPlanner(tsh.MeshSpec(n_data, n_model, **REF_MESH))
    blocks = [tsh.LayerShape(f"b{i}", t, di, do, bpe)
              for i, (t, di, do, bpe) in enumerate(
                  (t, di, do, bpe) for t in (1, 128, 4096, 1 << 20)
                  for di in (256, 4096, 16384) for do in (512, 24576)
                  for bpe in (1, 2))]
    want = jp.plan([jsh.LayerShape(b.name, b.tokens, b.d_in, b.d_out,
                                   b.bytes_per_elt) for b in blocks])
    got = tp.plan(blocks)
    assert {k: v.fmt for k, v in got.items()} == \
        {k: v.fmt for k, v in want.items()}
    for k in want:
        assert got[k].t_depth == pytest.approx(want[k].t_depth, rel=1e-12)
        assert got[k].t_line == pytest.approx(want[k].t_line, rel=1e-12)
    assert len({v.fmt for v in got.values()}) == 2     # both formats occur


def test_mesh_spec_defaults_are_the_h100s():
    """No TPU rate is a default: one H100 SXM's data-sheet rates."""
    m = tsh.MeshSpec(1, 1)
    assert (m.flops_per_chip, m.hbm_gbps, m.ici_gbps) == (989e12, 3.35e12,
                                                          450e9)
    assert (m.flops_per_chip, m.hbm_gbps, m.ici_gbps) != tuple(
        REF_MESH.values())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine_decode_shards_matches_reference(seed):
    """The lse merge of N shards' partials, one shard empty (lse -1e30),
    within 2e-4 of the reference's in float32."""
    rng = np.random.default_rng(seed)
    N, B, H, D = 4, 3, 5, 16
    outs = rng.normal(size=(N, B, H, D)).astype(np.float32)
    lses = rng.normal(size=(N, B, H)).astype(np.float32) * 3
    lses[1] = -1e30
    want = np.asarray(jref.combine_decode_shards(jnp.asarray(outs),
                                                 jnp.asarray(lses)))
    got = ops.combine_decode_shards(torch.from_numpy(outs),
                                    torch.from_numpy(lses)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_combine_of_split_decode_equals_one_decode():
    """K3's plain version over each half of the keys, merged by lse,
    equals one decode over all of them (what ``_decode_seq_sharded``
    computes across ranks)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 32, generator=g)
    k = torch.randn(2, 1, 16, 32, generator=g)
    v = torch.randn(2, 1, 16, 32, generator=g)
    kv_len = torch.tensor([11, 5])
    whole = ops.flash_decode(q, k, v, kv_len=kv_len)
    parts = [ops.flash_decode(q, k[:, :, i:i + 8], v[:, :, i:i + 8],
                              kv_len=torch.clamp(kv_len - i, 0, 8),
                              return_lse=True) for i in (0, 8)]
    merged = ops.combine_decode_shards(torch.stack([o for o, _ in parts]),
                                       torch.stack([l for _, l in parts]))
    torch.testing.assert_close(merged, whole, atol=2e-6, rtol=2e-6)


def test_bucket_tree_and_overlap_flags_equal_the_reference():
    rng = np.random.default_rng(0)
    tree = {"b": [rng.normal(size=(300, 700)).astype(np.float32),
                  np.zeros((5,), np.float32)],
            "a": {"w": np.zeros((1024, 1024), np.float32),
                  "v": np.zeros((2048, 600), np.float16)}}
    for size in (4 << 20, 1 << 20, 64):
        want = [[i for i, _ in b] for b in joverlap.bucket_tree(tree, size)]
        got = [[i for i, _ in b] for b in toverlap.bucket_tree(tree, size)]
        assert got == want
    flat = [torch.zeros(3, 5), torch.zeros(1 << 20), torch.zeros(7)]
    assert [[i for i, _ in b] for b in toverlap.bucket_tree(flat)] == \
        [[0], [1], [2]]
    assert toverlap.overlap_flags() == joverlap.overlap_flags()


def test_no_mesh_is_identity_and_the_local_mesh_has_no_group():
    x = torch.ones(2, 3)
    assert tsh.active_mesh_axes() == () and tsh.mesh_axis_size("model") == 1
    assert tsh.maybe_shard(x, "data", None) is x
    assert not tsh.model_parallel()
    m = tmesh.single_device_mesh(device="cpu")
    with tmesh.use_mesh(m):
        assert tsh.active_mesh_axes() == ("data", "model")
        assert tsh.mesh_axis_size("data") == tsh.mesh_axis_size("model") == 1
        assert tsh.maybe_shard(x, "data", None) is x
        assert tsh.local(x, 1) is x and tsh.full(x) is x
    assert tsh.active_mesh_axes() == ()
    with pytest.raises(RuntimeError, match="4 ranks"):
        tmesh.make_mesh(2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError):
        tmesh.LocalMesh((2, 1), ("data", "model"))


def test_kernel_ops_refuse_a_dtensor():
    """No DTensor reaches a kernel's op: under a mesh each rank passes
    its local shard (a stand-in whose class is named DTensor here; the
    gloo tests pass a real one)."""
    class DTensor(torch.Tensor):
        pass

    q = torch.zeros(1, 2, 4, 8).as_subclass(DTensor)
    k = torch.zeros(1, 2, 4, 8)
    with pytest.raises(TypeError, match="DTensor"):
        ops.flash_attention(q, k, k)
    with pytest.raises(TypeError, match="DTensor"):
        ops.flash_decode(q[:, :, 0], k, k)
    with pytest.raises(TypeError, match="DTensor"):
        ops.neutron_matmul(q[0, 0], k[0, 0].T)
