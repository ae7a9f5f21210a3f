"""The dry run (ROADMAP item 13) against the JAX package on the CPU.

  * the registry's shape functions for every arch and cell: ``cells``,
    ``input_specs`` and ``decode_aux_specs`` (names, shapes, dtypes),
    the abstract parameters, training state and caches built on the meta
    device (through ``convert.reference_leaves``, the shapes and dtypes
    of the reference's ``jax.eval_shape`` trees), ``build_step``'s specs
    (the reference's PartitionSpecs as tuples) and donations,
    ``model_flops_for`` and ``active_params``;
  * at a small size (a reduced config of each family and a small
    ``ShapeSpec`` set into both packages' ``SHAPES``), each bundle's
    ``fn`` on real CPU tensors against the reference's bundle ``fn`` run
    by jax, within 2e-4 in float32 (``tests/test_torch_lm.py``'s bound);
  * the cost counter: ``2 M K N`` operations and the bytes of one
    ``nn.Linear``, each kernel's meta report against the formulas of
    ``kernels/work.py`` (which ``chip_smoke.py`` imports), the ring
    model against the reference's ``collective_bytes``, and the dense
    products of a reduced prefill against the reference's
    ``analyze_hlo`` of ``jax.jit(lm.prefill)``;
  * ``launch.dryrun``: every arch's ``train_4k`` cell traced at the
    single-pod mesh (16 x 16, a fake process group of 256 ranks) in a
    subprocess that imports neither jax nor the JAX package, and each
    rank's parameter bytes at 16 x 16 and 2 x 16 x 16 against the
    reference's ``state_specs`` applied to its own abstract tree.  The
    prefill, decode and long-context cells run in ``chip_smoke.py``'s
    phase 21 (and by ``--all``): the whole single-pod table takes about
    three minutes on one CPU worker.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jrl
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.models import train as jtrain
from repro_torch.analysis import cost as tcost
from repro_torch.analysis import roofline as trl
from repro_torch.kernels import ops, work
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models import sharding
from repro_torch.models.convert import (params_from_numpy,
                                        reference_leaves,
                                        train_state_from_numpy,
                                        train_state_to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(treg.ARCH_IDS)
CELLS = [(a, c) for a in ARCHS for c in jreg.cells(jreg.get_arch(a))]
DECODE_CELLS = [(a, c) for a, c in CELLS
                if jreg.SHAPES[c].kind == "decode"]
TOL = dict(atol=2e-4, rtol=2e-4)
_DT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.int32): torch.int32}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jax_leaves(tree):
    """{"a/b/c": (shape, torch dtype)} of a tree of ShapeDtypeStructs."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_key(k) for k in path): (tuple(x.shape),
                                              _DT[jnp.dtype(x.dtype)])
            for path, x in flat}


def _port_leaves(tree):
    out = {}

    def put(path, t):
        out["/".join(map(str, path))] = (tuple(t.shape), t.dtype)
    sharding.map_with_path(put, tree)
    return out


def _reference_shapes(cfg, model, tensors=None):
    """{"a/b/c": (stacked shape, dtype)} of the port's parameters, or of
    `tensors` laid out as them (moments), in the reference's layout."""
    index = {id(p): i for i, p in enumerate(model.parameters())}
    out = {}
    for path, lead, ts in reference_leaves(cfg, model):
        t = ts[0] if tensors is None else tensors[index[id(ts[0])]]
        out["/".join(path)] = ((*lead, *t.shape), t.dtype)
    return out


# --------------------------------------------------------------------------
# the registry's shape functions, every arch and cell
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_the_reference(arch):
    assert treg.cells(treg.get_arch(arch)) == \
        jreg.cells(jreg.get_arch(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_aux_specs_equal_the_reference(arch):
    """Names, shapes and dtypes of every cell's inputs (meta tensors) and,
    for whisper's decode cells, of the decode step's aux."""
    jcfg, tcfg = jreg.get_arch(arch), treg.get_arch(arch)
    for cell in jreg.cells(jcfg):
        got = treg.input_specs(tcfg, cell)
        assert all(t.is_meta for t in got.values())
        assert _port_leaves(got) == _jax_leaves(jreg.input_specs(jcfg,
                                                                 cell))
        want_aux = jreg.decode_aux_specs(jcfg, cell)
        got_aux = treg.decode_aux_specs(tcfg, cell)
        assert (got_aux is None) == (want_aux is None)
        if want_aux is not None:
            assert _port_leaves(got_aux) == _jax_leaves(want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_train_state_equal_the_reference(arch):
    """The LM and TrainState built on meta (no values drawn) have, leaf by
    leaf through ``reference_leaves``, the shapes and dtypes of the
    reference's eval_shape trees: parameters, both moments (bf16 above
    50B parameters), the step; and the error feedback when compressing."""
    jcfg, tcfg = jreg.get_arch(arch), treg.get_arch(arch)
    model = treg.abstract_params(tcfg)
    assert all(p.is_meta for p in model.parameters())
    assert _reference_shapes(tcfg, model) == \
        _jax_leaves(jreg.abstract_params(jcfg))
    topts = treg.TrainOptions(compress_grads=True)
    st = treg.abstract_train_state(tcfg, opts=topts)
    jst = jax.eval_shape(lambda k: jtrain.init_train_state(
        jcfg, k, opts=jtrain.TrainOptions(compress_grads=True)),
        jax.random.PRNGKey(0))
    for got, want in ((st.opt.m, jst.opt.m), (st.opt.v, jst.opt.v),
                      (st.error_fb, jst.error_fb)):
        assert _reference_shapes(tcfg, st.params, got) == _jax_leaves(want)
    assert (tuple(st.opt.step.shape), st.opt.step.dtype) == \
        ((), torch.int32) and jst.opt.step.shape == ()


@pytest.mark.parametrize("arch,cell", DECODE_CELLS)
def test_abstract_cache_equals_the_reference(arch, cell):
    ss = jreg.SHAPES[cell]
    got = treg.abstract_cache(treg.get_arch(arch), ss.global_batch,
                              ss.seq_len)
    want = jreg.abstract_cache(jreg.get_arch(arch), ss.global_batch,
                               ss.seq_len)
    assert _port_leaves(got) == _jax_leaves(want)


def _spec_tree(x):
    """A reference spec tree with PartitionSpecs as tuples, or a port spec
    tree, as nested dicts / lists with tuple leaves."""
    from jax.sharding import PartitionSpec
    if isinstance(x, PartitionSpec):
        return tuple(x)
    if isinstance(x, dict):
        return {k: _spec_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _spec_tree(getattr(x, f)) for f in x._fields}
    if isinstance(x, list):
        return [_spec_tree(v) for v in x]
    if x is None:
        return None
    if isinstance(x, tuple) and all(
            s is None or isinstance(s, (str, tuple)) for s in x):
        return tuple(x)
    return [_spec_tree(v) for v in x]


@pytest.mark.parametrize("arch,cell", CELLS)
def test_build_step_specs_equal_the_reference(arch, cell):
    """in_specs, out_specs and donations of every cell's bundle, single
    pod and two pods, and the arguments' meta shapes without a mesh."""
    for with_pod in (False, True):
        want = jreg.build_step(jreg.get_arch(arch), cell, with_pod=with_pod)
        got = treg.build_step(treg.get_arch(arch), cell, with_pod=with_pod)
        assert _spec_tree(list(got.in_specs)) == \
            _spec_tree(list(want.in_specs))
        assert _spec_tree(got.out_specs) == _spec_tree(want.out_specs)
        assert tuple(got.donate) == tuple(want.donate)
    ss = jreg.SHAPES[cell]
    if ss.kind == "decode":
        assert got.args[3] == ss.seq_len - 1
        assert tuple(got.args[2].shape) == (ss.global_batch,)
    else:
        assert _port_leaves(got.args[1]) == _jax_leaves(want.args[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    jcfg, tcfg = jreg.get_arch(arch), treg.get_arch(arch)
    assert trl.active_params(tcfg) == jrl.active_params(jcfg)
    for cell in jreg.cells(jcfg):
        assert trl.model_flops_for(tcfg, treg.SHAPES[cell]) == \
            jrl.model_flops_for(jcfg, jreg.SHAPES[cell])


def test_the_roofline_holds_the_h100s_constants_only():
    """No TPU constant (197e12, 819e9) in the port's roofline; the H100's
    rates, and one bound for one kernel call as chip_smoke's table."""
    src = open(os.path.join(ROOT, "src/repro_torch/analysis/roofline.py")
               ).read()
    for tpu in ("197e12", "819e9"):
        assert tpu not in src
    assert trl.HBM_BYTES_S == 3.35e12 and trl.LINK_BYTES_S == 50e9
    assert trl.PEAK_FLOPS == {"bfloat16": 989e12, "int8": 1979e12,
                              "tf32": 495e12, "float32": 67e12}
    ms, by = trl.bound(3.35e9, 989e9, "bfloat16")
    assert math.isclose(ms, 1.0) and by in ("bytes", "operations")
    r = trl.build_roofline("a", "s", "1x1", 1, 989e12 + 67e12, 3.35e12 / 2,
                           0.0, 1.0, flops_by_rate={"bfloat16": 989e12,
                                                    "float32": 67e12})
    assert math.isclose(r.t_compute, 2.0) and r.bottleneck == "compute"
    assert math.isclose(r.bound_s, 2.0)


# --------------------------------------------------------------------------
# each family's bundle fn at a small size against the reference's
# --------------------------------------------------------------------------

FAMILIES = {"dense": "minitron-4b", "moe": "granite-moe-1b-a400m",
            "mla": "deepseek-v3-671b", "ssm": "mamba2-370m",
            "hybrid": "zamba2-2.7b", "grouped": "gemma3-27b",
            "audio": "whisper-tiny", "vlm": "qwen2-vl-2b"}
SMALL = {"train": jreg.ShapeSpec("tiny_train", 16, 2, "train"),
         "prefill": jreg.ShapeSpec("tiny_prefill", 16, 2, "prefill"),
         "decode": jreg.ShapeSpec("tiny_decode", 24, 2, "decode")}


def _small_cfgs(arch):
    jcfg = jreg.get_arch(arch).reduced(dtype="float32")
    tcfg = treg.get_arch(arch).reduced(dtype="float32")
    if jcfg.n_experts:          # no drop: the same tokens kept both ways
        f = jcfg.n_experts / jcfg.top_k
        jcfg = jcfg.reduced(dtype="float32", capacity_factor=f)
        tcfg = tcfg.reduced(dtype="float32", capacity_factor=f)
    return jcfg, tcfg


def _small_batch(cfg, ss, seed):
    rng = np.random.default_rng(seed)
    B, S = ss.global_batch, ss.seq_len
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.enc_dec:
        b["audio_embed"] = rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["vision_embed"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return b


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture
def small_shapes(monkeypatch):
    for ss in SMALL.values():
        monkeypatch.setitem(jreg.SHAPES, ss.name, ss)
        monkeypatch.setitem(treg.SHAPES, ss.name,
                            treg.ShapeSpec(ss.name, ss.seq_len,
                                           ss.global_batch, ss.kind))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_small_train_bundle_matches_the_reference(family, small_shapes):
    """Two steps of each bundle's train step from the reference's state:
    loss, grad norm and the parameters within 2e-4."""
    jcfg, tcfg = _small_cfgs(FAMILIES[family])
    ss = SMALL["train"]
    jb = jreg.build_step(jcfg, ss.name)
    tb = treg.build_step(tcfg, ss.name)
    jstate = jtrain.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    jfn = jax.jit(jb.fn)
    for i in range(2):
        b = _small_batch(jcfg, ss, i)
        jstate, jm = jfn(jstate, b)
        tstate, tm = tb.fn(tstate, b)
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                2e-4 * max(abs(float(jm[k])), 1e-30), (k, tm[k], jm[k])
    got = train_state_to_numpy(tcfg, tstate).params
    for (path, a), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(np.asarray, jstate.params))[0]):
        np.testing.assert_allclose(_np(a), _np(w), err_msg=str(path),
                                   **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_small_prefill_bundle_matches_the_reference(family, small_shapes):
    jcfg, tcfg = _small_cfgs(FAMILIES[family])
    ss = SMALL["prefill"]
    params = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    model = params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    b = _small_batch(jcfg, ss, 3)
    want = jax.jit(jreg.build_step(jcfg, ss.name).fn)(params, b)
    with torch.no_grad():
        got = treg.build_step(tcfg, ss.name).fn(model, b)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_small_decode_bundle_matches_the_reference(family, small_shapes):
    """Three decode steps of each bundle's serve step from a zero cache
    (whisper with its aux from the reference's encoder): logits and every
    cache leaf within 2e-4."""
    jcfg, tcfg = _small_cfgs(FAMILIES[family])
    ss = SMALL["decode"]
    params = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    model = params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    jb, tb = jreg.build_step(jcfg, ss.name), treg.build_step(tcfg, ss.name)
    jcache = jlm.init_cache(jcfg, ss.global_batch, ss.seq_len)
    tcache = tlm.init_cache(tcfg, ss.global_batch, ss.seq_len, "cpu")
    jaux = taux = None
    if jcfg.enc_dec:
        audio = np.random.default_rng(4).normal(
            size=(ss.global_batch, jcfg.n_audio_frames,
                  jcfg.d_model)).astype(np.float32)
        enc = jlm.encode_audio(jcfg, params, jnp.asarray(audio))
        jaux = {"enc_states": enc, "cross_kv": jlm.cross_kv(jcfg, params,
                                                             enc)}
        taux = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)), jaux)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (ss.global_batch, 3)).astype(np.int32)
    jfn = jax.jit(jb.fn)
    for t in range(3):
        pos = 7 + t
        jl, jcache = jfn(params, jcache, jnp.asarray(toks[:, t]),
                         jnp.int32(pos), jaux)
        with torch.no_grad():
            tl, tcache = tb.fn(model, tcache, toks[:, t], pos, taux)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    want = {"/".join(_key(k) for k in path): w for path, w in
            jax.tree_util.tree_flatten_with_path(jcache)[0]}
    got = {}
    sharding.map_with_path(
        lambda p, x: got.__setitem__("/".join(map(str, p)), x), tcache)
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        np.testing.assert_allclose(_np(a), _np(want[path]), err_msg=path,
                                   **TOL)


# --------------------------------------------------------------------------
# the cost counter
# --------------------------------------------------------------------------


def test_linear_counts_2mkn_operations_and_its_bytes():
    M, K, N = 12, 40, 24
    lin = torch.nn.Linear(K, N, bias=False, device="meta")
    x = torch.empty(M, K, device="meta")
    with tcost.CostCounter(arguments=(lin, x)) as c:
        y = lin(x)
    assert c.cost.flops == 2 * M * K * N
    assert c.cost.flops_by_rate == {"float32": 2 * M * K * N}
    assert c.cost.bytes == 4 * (M * K + K * N + M * N)
    assert c.cost.argument_bytes == 4 * (M * K + K * N)
    assert c.cost.peak_bytes == 4 * (M * K + K * N + M * N)
    assert y.is_meta and not c.cost.kernel_calls


def test_the_counter_refuses_a_tensor_off_the_meta_device():
    x = torch.empty(4, device="meta")
    with pytest.raises(RuntimeError, match="off the meta device"):
        with tcost.CostCounter(arguments=x):
            torch.zeros(4)


def test_peak_counts_what_is_alive_at_once():
    """Two temporaries alive together count twice; one freed before the
    next is made counts once; the arguments count once either way."""
    x = torch.empty(256, device="meta")
    with tcost.CostCounter(arguments=x) as c:
        a = x * 2
        b = x * 3
        del a, b
    assert c.cost.peak_bytes == 1024 + 2 * 1024
    with tcost.CostCounter(arguments=x) as c:
        a = x * 2
        del a
        b = x * 3
        del b
    assert c.cost.peak_bytes == 1024 + 1024


def _kernel_cases():
    """name -> (call(device) building the inputs on `device` and calling
    the op, kernel name, {rate: operations} of the call)."""
    B, H, Hkv, S, D, Dv = 2, 4, 2, 24, 16, 8
    Bs, Ss, Hs, P, N, L = 2, 32, 3, 8, 16, 16
    bf = torch.bfloat16

    def e(dev, *shape, dtype=torch.float32):
        if dev == "meta":
            return torch.empty(shape, dtype=dtype, device=dev)
        return torch.randn(shape).to(dtype)

    def k2(dev):
        return ops.flash_attention(e(dev, B, H, S, D), e(dev, B, Hkv, S, D),
                                   e(dev, B, Hkv, S, Dv), causal=True,
                                   window=5)

    def k2_lse(dev):
        q, k, v = (e(dev, B, H, S, D, dtype=bf), e(dev, B, H, 40, D, dtype=bf),
                   e(dev, B, H, 40, Dv, dtype=bf))
        if dev == "meta":
            return ops._meta.flash_attention(q, k, v, causal=False,
                                             return_lse=True)
        return ops._ref.flash_attention_fwd_lse_ref(q, k, v, causal=False)

    def k3(dev):
        return ops.flash_decode(e(dev, B, H, D, dtype=bf),
                                e(dev, B, Hkv, 40, D, dtype=bf),
                                e(dev, B, Hkv, 40, Dv, dtype=bf),
                                return_lse=True)

    def ssd_args(dev):
        return (e(dev, Bs, Ss, Hs, P, dtype=bf), e(dev, Bs, Ss, Hs),
                e(dev, Hs), e(dev, Bs, Ss, N, dtype=bf),
                e(dev, Bs, Ss, N, dtype=bf))

    def k4(dev):
        if dev == "meta":
            return ops._meta.ssd_chunk(*ssd_args(dev), L)
        return ops._ref.ssd_chunk_ref(*ssd_args(dev), L)

    def k1(dev):
        return ops.neutron_matmul(e(dev, 20, 12), e(dev, 12, 6))

    def k1_nk(dev):
        out = torch.empty(2, 10, 6, device=dev)
        return ops.neutron_matmul_nk(e(dev, 2, 10, 12), e(dev, 6, 12),
                                     e(dev, 6), "relu", out)

    return {
        "flash_attention causal window": (k2, "flash_attention", {
            "float32": work.flash_attention_flops(B, H, S, S, D, Dv, True,
                                                  5)}),
        "flash_attention not causal with lse": (k2_lse, "flash_attention", {
            "bfloat16": work.flash_attention_flops(B, H, S, 40, D, Dv,
                                                   False, None)}),
        "flash_decode with lse": (k3, "flash_decode", {
            "bfloat16": work.flash_decode_flops(B, H, 40, D, Dv)}),
        "ssd_chunk": (k4, "ssd_chunk", {
            "bfloat16": work.ssd_flops(Bs, Ss, Hs, P, N, L)}),
        "neutron_matmul": (k1, "neutron_matmul",
                           work.matmul_flops(20, 6, 12, torch.float32)),
        "neutron_matmul_nk": (k1_nk, "neutron_matmul",
                              work.matmul_flops(20, 6, 12, torch.float32)),
    }


@pytest.mark.parametrize("case", list(_kernel_cases()))
def test_kernel_meta_reports_equal_the_formulas(case):
    """Each kernel's meta version returns the shapes and dtypes of the
    plain version's outputs on CPU tensors of the same shapes, and
    reports one call, the formulas' operations and at least its outputs'
    bytes."""
    call, kernel, flops = _kernel_cases()[case]
    with tcost.CostCounter() as c:
        out = call("meta")
    outs = out if isinstance(out, tuple) else (out,)
    assert c.cost.kernel_calls == {kernel: 1}
    assert c.cost.flops_by_rate == flops
    assert all(o.is_meta for o in outs)
    with torch.no_grad():
        cpu = call("cpu")
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    assert [(tuple(o.shape), o.dtype) for o in outs] == \
        [(tuple(o.shape), o.dtype) for o in cpu]
    assert c.cost.bytes >= work.nbytes(*outs)


@pytest.mark.parametrize("grad", ["flash_attention_bwd", "ssd_chunk_bwd"])
def test_backward_kernels_report_under_grad(grad):
    """K2b and K4b through ``FlashAttentionFn`` / ``SSDChunkFn`` on meta:
    one call each, the formulas' operations, gradients of the inputs'
    shapes."""
    m = dict(device="meta", requires_grad=True)
    with tcost.CostCounter() as c:
        if grad == "flash_attention_bwd":
            B, H, S, D = 2, 4, 32, 16
            q, k, v = (torch.empty(B, H, S, D, dtype=torch.bfloat16, **m)
                       for _ in range(3))
            o = ops.flash_attention(q, k, v, causal=True)
            gs = torch.autograd.grad(o.float().sum(), (q, k, v))
            want = {"bfloat16": work.flash_attention_flops(
                B, H, S, S, D, D, True, None)
                + work.flash_attention_bwd_flops(B, H, S, S, D, D, True,
                                                 None)}
            assert c.cost.kernel_calls["flash_attention"] == 1
        else:
            B, S, H, P, N, L = 2, 32, 3, 8, 16, 16
            x = torch.empty(B, S, H, P, dtype=torch.bfloat16, **m)
            dt = torch.empty(B, S, H, **m)
            A = torch.empty(H, **m)
            Bm = torch.empty(B, S, N, dtype=torch.bfloat16, **m)
            Cm = torch.empty(B, S, N, dtype=torch.bfloat16, **m)
            y, _ = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=L)
            gs = torch.autograd.grad(y.float().sum(), (x, dt, A, Bm, Cm))
            bwd = work.ssd_bwd_flops(B, S, H, P, N, L)
            fwd = work.ssd_flops(B, S, H, P, N, L)
            assert c.cost.kernel_calls["ssd_chunk"] == 1
            got = c.cost.flops_by_rate
            assert got["tf32"] == bwd["tf32"]
            assert got["bfloat16"] == fwd + bwd["bfloat16"]
            want = None
    assert c.cost.kernel_calls[grad] == 1
    if want is not None:
        assert c.cost.flops_by_rate == want
    assert all(g.is_meta for g in gs)


KINDS = {"all-gather": "all-gather", "all-reduce": "all-reduce",
         "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
         "collective-permute": "collective-permute"}


@pytest.mark.parametrize("kind", list(KINDS))
def test_ring_wire_equals_the_reference(kind):
    n = 16
    groups = "replica_groups={{" + ",".join(map(str, range(n))) + "}}"
    if kind == "collective-permute":
        groups = "source_target_pairs={{0,1},{1,0}}"
    line = (f"%c = f32[64,8]{{1,0}} {kind}(f32[64,8]{{1,0}} %x), {groups}")
    want = jrl.collective_bytes(line)
    assert want.op_count == {kind: 1}
    assert tcost.ring_wire(kind, 64 * 8 * 4, n) == \
        pytest.approx(want.total_wire_bytes, rel=1e-12)


def test_dense_products_match_analyze_hlo_of_the_reference_prefill():
    """Reduced minitron-4b's prefill at (2, 64): the port's operations on
    meta within 2% of ``analyze_hlo(...).flops`` of the reference's
    ``jax.jit(lm.prefill)`` once the attention difference is added.  The
    convention: the reference's lowering on the CPU (``flash_attention
    _ref``, one key block here) scores every (query, key) pair, K2 only
    the causal ones, so the reference's count exceeds the port's by
    2 (D + Dv) B H (S^2 - S (S + 1) / 2) in each layer."""
    jcfg = jreg.get_arch("minitron-4b").reduced(dtype="float32")
    tcfg = treg.get_arch("minitron-4b").reduced(dtype="float32")
    B, S = 2, 64
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = jnp.zeros((B, S), jnp.int32)
    text = jax.jit(lambda p, t: jlm.prefill(jcfg, p, {"tokens": t})).lower(
        params, tokens).compile().as_text()
    want = jhlo.analyze_hlo(text).flops
    model = treg.abstract_params(tcfg)
    with tcost.CostCounter() as c:
        tlm.prefill(tcfg, model, {"tokens": torch.empty(
            B, S, dtype=torch.int32, device="meta")})
    H, D = tcfg.padded_heads, tcfg.head_dim
    extra = tcfg.n_layers * 2 * (D + D) * B * H * (S * S - S * (S + 1) // 2)
    assert c.cost.kernel_calls == {"flash_attention": tcfg.n_layers}
    assert abs(c.cost.flops + extra - want) <= 0.02 * want, \
        (c.cost.flops, extra, want)


# --------------------------------------------------------------------------
# launch.dryrun in a subprocess without jax
# --------------------------------------------------------------------------

DRY_SCRIPT = r'''
import json, sys, warnings
warnings.filterwarnings("ignore")
import torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, use_mesh
from repro_torch.models import registry, sharding
out = {"cells": {}, "param_bytes": {}}
for arch in registry.ARCH_IDS:
    art = dryrun.run_cell(arch, "train_4k", out_dir=sys.argv[2])
    out["cells"][arch] = art
for multi_pod in (False, True):
    dryrun.fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    for arch in registry.ARCH_IDS:
        cfg = registry.get_arch(arch)
        with use_mesh(mesh):
            model = registry.abstract_params(cfg)
            sharding.shard_params(cfg, model)
        out["param_bytes"]["%s %d" % (arch, multi_pod)] = sum(
            p.numel() * p.element_size() for p in model.parameters())
out["jax"] = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "repro" or m.startswith("repro."))
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    d = tmp_path_factory.mktemp("dry")
    path = str(d / "out.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", DRY_SCRIPT, path, str(d)],
                   env=env, cwd=ROOT, check=True, timeout=900)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_traces_the_train_cell_without_jax(dry, arch):
    """``run_cell(arch, "train_4k")`` at 16 x 16 ends, with no jax and no
    JAX package imported and nothing allocated off the meta device (the
    counter raises otherwise): K2 twice a layer's attention (forward and
    remat; once in zamba2's shared block, which runs outside remat), K2b
    once, K4 / K4b likewise for the SSD layers, collectives
    on the rank's groups, peak above the arguments, and the artifact on
    disk."""
    assert dry["jax"] == []
    art = dry["cells"][arch]
    cfg = treg.get_arch(arch)
    assert (art["mesh"], art["chips"], art["shape"]) == \
        ("16x16", 256, "train_4k")
    calls = art["kernel_calls"]
    if not cfg.attn_free:       # zamba2's shared block runs outside remat
        again = 1 if cfg.family == "hybrid" else 2
        assert calls["flash_attention"] == \
            again * calls["flash_attention_bwd"] > 0
    if cfg.family in ("ssm", "hybrid"):
        assert calls["ssd_chunk"] == 2 * calls["ssd_chunk_bwd"] > 0
    assert art["collective_counts"]["all-gather"] > 0
    mem = art["memory_analysis"]
    assert mem["peak_size_in_bytes"] > mem["argument_size_in_bytes"] > \
        mem["state_size_in_bytes"] > 0
    r = art["roofline"]
    assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
    assert art["bound_s"] == max(r["t_compute"], r["t_memory"],
                                 r["t_collective"])


def _reference_rank_bytes(arch, multi_pod):
    """Bytes of one rank's parameters by the reference's ``state_specs``
    on its own abstract tree (the production mesh's axis sizes)."""
    cfg = jreg.get_arch(arch)
    tree = jreg.abstract_params(cfg)
    specs = jreg.state_specs(cfg, tree, multi_pod)
    sizes = {"data": 16, "model": 16, "pod": 2}
    total = 0
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree), flat_specs):
        shape = list(leaf.shape)
        for d, s in enumerate(tuple(spec)):
            for name in (s if isinstance(s, tuple) else (s,)):
                if name is not None:
                    assert shape[d] % sizes[name] == 0
                    shape[d] //= sizes[name]
        total += math.prod(shape) * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_parameter_bytes_equal_the_reference_specs(dry, arch):
    """Each rank's parameters after ``shard_params`` on the production
    meshes (FSDP over `data` for deepseek-v3 and nemotron) hold the
    bytes the reference's specs give a rank."""
    for multi_pod in (0, 1):
        assert dry["param_bytes"][f"{arch} {multi_pod}"] == \
            _reference_rank_bytes(arch, bool(multi_pod))
