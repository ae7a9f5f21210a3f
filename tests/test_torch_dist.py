"""Distribution (ROADMAP item 12) on gloo worlds on the CPU, against the
JAX package on a host platform of 4 CPU devices.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu`` (``REF_SCRIPT``), at meshes (data, model) of
(2, 1), (1, 2) and (2, 2): ``moe_a2a`` (granite-moe-1b-a400m reduced,
float32, where tokens drop, so its result is not ``moe_dense``'s),
``attention``'s decode against a cache (granite-20b reduced: one kv head,
so the cache is sequence-sharded over ``model`` and decode runs
``_decode_seq_sharded``; two steps, at positions owned by either half),
and the train step of minitron-4b reduced in float32: one step jitted
with the state laid out by ``state_specs`` on the mesh, and three steps
jitted without a mesh.  Where jax 0.9.0 does not lower the reference's
sharded function, the port is held to the reference's function without
a mesh, which computes the same: decode at (2, 1) (a
``ShardingTypeError`` of its ``dynamic_update_slice`` on a data-sharded
cache), a second sharded train step (the ``ShardingTypeError`` of
``tests/test_train_e2e.py``) and granite-moe's sharded train step with
``moe_a2a`` (its layer scan's carry changes type), which runs at a
capacity factor of E / k, where no token drops.

The port runs the same inputs in gloo worlds of the same shapes, one
process a rank (``torch.multiprocessing.spawn``, a ``FileStore`` under
``tmp_path``), each rank on its rows and shards.  Tolerances in float32:
outputs within 2e-4; the train step's loss and grad norm within 2e-4
relative, parameters within ``2 lr sum(lr_scale)`` plus 2e-4 relative
(as ``tests/test_torch_train.py``); every rank of a world holds the same
loss bits.  Also here: ``launch.train(n_data=2)`` resumes from a
checkpoint bit-equal, DTensor placements of the specs, and every other
family (ssm, hybrid, gemma3's windows, whisper, qwen2-vl, deepseek-v3
with its mtp block) trained two steps on a (1, 2) mesh against the
port's own one-process steps.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 1), (1, 2), (2, 2)]
TOL = 2e-4
LR = 3e-4
SEQ, BATCH, STEPS = 16, 4, 3
DEC_B, DEC_S, DEC_POS = 4, 16, (5, 12)

FAMILY_ARCHS = ["mamba2-370m", "zamba2-2.7b", "gemma3-27b", "whisper-tiny",
                "qwen2-vl-2b", "deepseek-v3-671b"]
FAM_STEPS, FAM_DEC = 2, 4

REF_SCRIPT = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.data import pipeline as jpipe
from repro.launch.mesh import make_mesh, named_shardings, use_mesh
from repro.models import attention as jattn, moe as jmoe, train as jtrain
from repro.models.registry import get_arch, state_specs

MESHES = [(2, 1), (1, 2), (2, 2)]
SEQ, BATCH, STEPS = 16, 4, 3
DEC_B, DEC_S, DEC_POS = 4, 16, (5, 12)
FAMILY_ARCHS = %r
FAM_STEPS, FAM_DEC = %d, %d
npy = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {"moe": {}, "decode": {}, "train": {}}

cfg = get_arch("granite-moe-1b-a400m").reduced(dtype="float32")
p = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
x = np.random.default_rng(1).normal(size=(4, 8, cfg.d_model)).astype(
    np.float32)
out["moe_in"] = (npy(p), x)
out["moe_dense"] = np.asarray(jmoe.moe_dense(p, jnp.asarray(x), cfg))
for m in MESHES:
    out["moe"][m] = np.asarray(jmoe.moe_a2a(p, jnp.asarray(x), cfg,
                                            mesh=make_mesh(*m)))

cfg2 = get_arch("granite-20b").reduced(dtype="float32")
pa = jattn.init_attention(jax.random.PRNGKey(2), cfg2, jnp.float32)
rng = np.random.default_rng(3)
hd = cfg2.head_dim
ck = rng.normal(size=(DEC_B, 1, DEC_S, hd)).astype(np.float32)
cv = rng.normal(size=(DEC_B, 1, DEC_S, hd)).astype(np.float32)
xs = [rng.normal(size=(DEC_B, 1, cfg2.d_model)).astype(np.float32)
      for _ in DEC_POS]
out["decode_in"] = (npy(pa), ck, cv, xs)

def decode(mesh):
    def run(p, ck, cv):
        os_ = []
        for x, pos in zip(xs, DEC_POS):
            o, (ck, cv) = jattn.attention(
                p, jnp.asarray(x), cfg2, jnp.full((DEC_B, 1), pos),
                kv_cache=(ck, cv), cache_pos=pos)
            os_.append(o)
        return os_, ck, cv
    if mesh is None:
        return npy(jax.jit(run)(pa, ck, cv))
    with use_mesh(mesh):
        return npy(jax.jit(run)(pa, ck, cv))
out["decode"][None] = decode(None)
for m in MESHES:
    if m[1] > 1:
        out["decode"][m] = decode(make_mesh(*m))

def train(arch, overrides, m, port_meshes):
    """The reference's train step from its initial state: STEPS steps
    jitted without a mesh, and one step jitted with the state laid out by
    state_specs on each mesh of m (a second step from that sharded
    state does not lower under jax 0.9.0); the port runs at
    port_meshes."""
    c = get_arch(arch).reduced(dtype="float32", **overrides)
    st = jtrain.init_train_state(c, jax.random.PRNGKey(0))
    s0 = npy(st)
    step = jtrain.make_train_step(c)
    dcfg = jpipe.DataConfig(vocab=c.vocab, seq_len=SEQ, global_batch=BATCH)
    batches = [jpipe.batch_for_step(dcfg, i) for i in range(STEPS)]
    res = {"s0": s0, "batches": batches, "arch": arch,
           "overrides": overrides, "meshes": port_meshes}
    j = jax.jit(step)
    ms = []
    for b in batches:
        st, met = j(st, b)
        ms.append({k: float(v) for k, v in met.items()})
    res["steps"] = (ms, npy(st.params))
    for mm in m:
        mesh = make_mesh(*mm)
        with use_mesh(mesh):
            sspec = named_shardings(mesh, state_specs(c, s0, n_model=mm[1]))
            repl = named_shardings(mesh, None)
            js = jax.jit(step, in_shardings=(sspec, repl),
                         out_shardings=(sspec, repl))
            st1, met = js(s0, batches[0])
        res[mm] = ([{k: float(v) for k, v in met.items()}],
                   npy(st1.params))
    return res
out["train"]["minitron-4b"] = train("minitron-4b", {}, MESHES, MESHES)
# granite-moe: through moe_a2a at (2, 2), where no token drops (capacity
# factor E / k); and at (2, 1), where the dense dispatch sees the global
# batch and tokens drop
out["train"]["granite-moe-1b-a400m"] = train(
    "granite-moe-1b-a400m", {"capacity_factor": 4.0}, [], [(2, 2)])
out["train"]["granite-moe-1b-a400m drops"] = train(
    "granite-moe-1b-a400m", {}, [(2, 1)], [(2, 1)])

def family(arch):
    """FAM_STEPS train steps jitted without a mesh from the initial state,
    and FAM_DEC decode steps from the initial parameters."""
    from functools import partial
    from repro.models import lm as jlm
    c = get_arch(arch).reduced(dtype="float32")
    if c.n_experts:         # no token drops: a2a is then the dense dispatch
        c = c.reduced(capacity_factor=c.n_experts / c.top_k)
    st = jtrain.init_train_state(c, jax.random.PRNGKey(0))
    s0 = npy(st)
    dcfg = jpipe.DataConfig(vocab=c.vocab, seq_len=SEQ, global_batch=BATCH)
    j = jax.jit(jtrain.make_train_step(c))
    ms = []
    for i in range(FAM_STEPS):
        b = jpipe.batch_for_step(dcfg, i)
        if c.enc_dec:
            b["audio_embed"] = audio(c, i)
        st, m = j(st, b)
        ms.append({k: float(v) for k, v in m.items()})
    params = jax.tree_util.tree_map(jnp.asarray, s0.params)
    aux = None
    if c.enc_dec:
        enc = jlm.encode_audio(c, params, jnp.asarray(audio(c, FAM_STEPS)))
        aux = {"enc_states": enc, "cross_kv": jlm.cross_kv(c, params, enc)}
    toks = np.random.default_rng(7).integers(0, c.vocab, (BATCH, FAM_DEC))
    cache = jlm.init_cache(c, BATCH, FAM_DEC)
    step = jax.jit(partial(jlm.decode_step, c))
    logits = []
    for t in range(FAM_DEC):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t]),
                         jnp.int32(t), aux)
        logits.append(np.asarray(lg))
    return {"s0": s0, "steps": (ms, npy(st.params)), "tokens": toks,
            "logits": logits}

def audio(c, i):
    return np.random.default_rng(i).normal(
        size=(BATCH, c.n_audio_frames, c.d_model)).astype(np.float32)

out["family"] = {a: family(a) for a in FAMILY_ARCHS}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
''' % (FAMILY_ARCHS, FAM_STEPS, FAM_DEC)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    # one XLA thread a device: the suite runs files side by side, some of
    # them timing-sensitive
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", REF_SCRIPT, path], env=env,
                   cwd=ROOT, check=True, timeout=600)
    with open(path, "rb") as f:
        return pickle.load(f)


# --------------------------------------------------------------------------
# the gloo worlds
# --------------------------------------------------------------------------


def _rank_main(rank, world, store_path, fn_name, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        globals()[fn_name](rank, world, *args)
    finally:
        dist.destroy_process_group()


def _spawn(tmp, fn_name, world, *args):
    """Run ``fn_name(rank, world, *args)`` on `world` gloo ranks."""
    store = str(tmp / f"store_{fn_name}_{world}_{os.getpid()}")
    mp.spawn(_rank_main, args=(world, store, fn_name, args), nprocs=world,
             join=True)


def _save(out_dir, tag, rank, obj):
    with open(os.path.join(out_dir, f"{tag}_{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def _load(out_dir, tag, rank):
    with open(os.path.join(out_dir, f"{tag}_{rank}.pkl"), "rb") as f:
        return pickle.load(f)


def _moe_module(cfg, tree):
    from repro_torch.models.moe import MoE
    m = MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        m.router.copy_(torch.from_numpy(tree["router"]))
        for k in ("w_in", "w_gate", "w_out"):
            getattr(m.experts, k).copy_(
                torch.from_numpy(tree["experts"][k]))
    return m


def _attention_module(cfg, tree):
    from repro_torch.models.attention import Attention
    a = Attention(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for k in ("wq", "wk", "wv", "wo"):
            getattr(a, k).copy_(torch.from_numpy(tree[k]))
    return a


def _mesh_world(rank, world, nd, nm, ref_path, out_dir):
    """Every check of one mesh on this rank: moe_a2a, decode, the train
    step(s); its results go to ``out_dir``."""
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import attention, sharding, train
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_numpy)
    from repro_torch.models.moe import moe_a2a
    from repro_torch.models.registry import get_arch
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    mesh = make_mesh(nd, nm, device="cpu")
    res = {}
    with use_mesh(mesh), torch.no_grad():
        rd = sharding.axis_rank("data")
        # moe_a2a: the experts split over `model` (expert parallelism)
        cfg = get_arch("granite-moe-1b-a400m").reduced(dtype="float32")
        tree, x = ref["moe_in"]
        p = _moe_module(cfg, tree)
        for w in (p.experts.w_in, p.experts.w_gate, p.experts.w_out):
            sharding.shard_tensor(w, ("model", None, None))
        rows = slice(rd * x.shape[0] // nd, (rd + 1) * x.shape[0] // nd)
        res["moe"] = (rows, moe_a2a(p, torch.from_numpy(x[rows]),
                                    cfg).numpy())
        # decode: two steps; the cache holds this rank's rows and, where
        # decode is sequence-sharded, its range of positions
        cfg2 = get_arch("granite-20b").reduced(dtype="float32")
        pa, ck, cv, xs = ref["decode_in"]
        a = _attention_module(cfg2, pa)
        rows = slice(rd * DEC_B // nd, (rd + 1) * DEC_B // nd)
        seq = attention._use_seq_sharded_decode(cfg2, DEC_B, DEC_S)
        cols = slice(None)
        if seq:
            rm, s_loc = sharding.axis_rank("model"), DEC_S // nm
            cols = slice(rm * s_loc, (rm + 1) * s_loc)
        kc = torch.from_numpy(ck[rows, :, cols].copy())
        vc = torch.from_numpy(cv[rows, :, cols].copy())
        outs = []
        for xd, pos in zip(xs, DEC_POS):
            o, _ = attention.attention(
                a, torch.from_numpy(xd[rows]), cfg2,
                torch.full((xd[rows].shape[0], 1), pos),
                kv_cache=(kc, vc), cache_pos=pos)
            outs.append(o.numpy())
        res["decode"] = (rows, cols, seq, outs, kc.numpy(), vc.numpy())
    # the train step: 3 steps from the reference's initial state, the
    # parameters kept after the first and the last
    for name, r in ref["train"].items():
        if (nd, nm) not in r["meshes"]:
            continue
        cfg = get_arch(r["arch"]).reduced(dtype="float32", **r["overrides"])
        with use_mesh(mesh):
            state = train_state_from_numpy(cfg, r["s0"], "cpu")
            step = train.make_train_step(cfg)
            rows = slice(rd * BATCH // nd, (rd + 1) * BATCH // nd)
            ms, ps = [], []
            for b in r["batches"]:
                state, met = step(state, {k: v[rows] for k, v in b.items()})
                ms.append({k: float(v) for k, v in met.items()})
                if len(ms) in (1, STEPS):
                    ps.append(train_state_to_numpy(cfg, state).params)
            res[("train", name)] = (ms, ps)
    _save(out_dir, f"mesh{nd}x{nm}", rank, res)


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """mesh -> [each rank's results]."""
    tmp = tmp_path_factory.mktemp("worlds")
    ref_path = str(tmp / "ref.pkl")
    with open(ref_path, "wb") as f:
        pickle.dump(ref, f)
    out = {}
    for nd, nm in MESHES:
        _spawn(tmp, "_mesh_world", nd * nm, nd, nm, ref_path, str(tmp))
        out[(nd, nm)] = [_load(str(tmp), f"mesh{nd}x{nm}", r)
                         for r in range(nd * nm)]
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_a2a_matches_reference(ref, worlds, mesh):
    """Each rank's rows of the port's moe_a2a equal the reference's
    moe_a2a at the same mesh within 2e-4; where tokens drop per shard
    that is not moe_dense's result."""
    want = ref["moe"][mesh]
    for rows, got in (r["moe"] for r in worlds[mesh]):
        np.testing.assert_allclose(got, want[rows], atol=TOL, rtol=TOL)
    if mesh[1] > 1:
        assert np.abs(want - ref["moe_dense"]).max() > 1e-3


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_seq_sharded_matches_reference(ref, worlds, mesh):
    """Two decode steps against a sequence-sharded cache (n_model > 1):
    each rank's outputs and its slice of the cache equal the reference's
    (at (2, 1), the reference's decode without a mesh)."""
    outs_want, ck_want, cv_want = ref["decode"].get(mesh,
                                                   ref["decode"][None])
    for rows, cols, seq, outs, kc, vc in (r["decode"] for r in
                                          worlds[mesh]):
        assert seq == (mesh[1] > 1)
        for got, want in zip(outs, outs_want):
            np.testing.assert_allclose(got, want[rows], atol=TOL,
                                       rtol=TOL)
        np.testing.assert_allclose(kc, ck_want[rows][:, :, cols],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(vc, cv_want[rows][:, :, cols],
                                   atol=TOL, rtol=TOL)


def _hold_train(ranks, arch, want_ms, want_p, n):
    """The first `n` steps of the port's run on every rank against the
    reference's metrics and parameters."""
    losses = {r[("train", arch)][0][n - 1]["loss"] for r in ranks}
    assert len(losses) == 1, losses         # the same bits on every rank
    ms, ps = ranks[0][("train", arch)]
    params = ps[0] if n == 1 else ps[-1]
    for got, want in zip(ms[:n], want_ms):
        for k in ("loss", "grad_norm", "lr_scale"):
            assert abs(got[k] - want[k]) <= TOL * max(abs(want[k]), 1e-30),\
                (k, got[k], want[k])
    atol = 2 * LR * sum(m["lr_scale"] for m in want_ms)
    import jax
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(want_p)[0]):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=atol,
                                   rtol=TOL, err_msg=str(path))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_train_step_matches_reference(ref, worlds, mesh):
    """Reduced minitron-4b (its 4 heads and 2 kv heads split over
    `model`, each data rank on its rows): the first step against the
    reference's train step jitted with the state laid out by
    ``state_specs`` on the same mesh.  A second step from the
    reference's sharded state raises jax 0.9.0's ``ShardingTypeError``
    (the embedding gather of ``tests/test_train_e2e.py``), so the three
    steps are held to the reference's ``jax.jit(make_train_step)``
    without a mesh, the same function."""
    r = ref["train"]["minitron-4b"]
    _hold_train(worlds[mesh], "minitron-4b", *r[mesh], 1)
    _hold_train(worlds[mesh], "minitron-4b", *r["steps"], STEPS)


def test_sharded_moe_train_step_matches_reference(ref, worlds):
    """Reduced granite-moe-1b-a400m at (2, 2), its MoE layers through
    moe_a2a, 3 steps.  The reference's sharded train step does not lower
    with moe_a2a under jax 0.9.0 (its layer scan's carry changes type),
    so the capacity factor is E / k, where no token drops and moe_a2a
    is the dense dispatch's function, and the port is held to the
    reference's ``jax.jit(make_train_step)`` without a mesh."""
    r = ref["train"]["granite-moe-1b-a400m"]
    _hold_train(worlds[(2, 2)], "granite-moe-1b-a400m", *r["steps"], STEPS)


def test_data_parallel_moe_sees_the_global_batch(ref, worlds):
    """Reduced granite-moe-1b-a400m at (2, 1), at its own capacity factor,
    where tokens drop: the dense dispatch takes the capacity of the
    global batch (each data rank gathers every rank's rows), so the first
    step equals the reference's sharded step."""
    name = "granite-moe-1b-a400m drops"
    _hold_train(worlds[(2, 1)], name, *ref["train"][name][(2, 1)], 1)


# --------------------------------------------------------------------------
# launch.train on a gloo world: restart, and DTensor placements
# --------------------------------------------------------------------------


def _train_world(rank, world, ckpt_dir, out_dir):
    from repro_torch.launch.train import train_loop
    kw = dict(seq_len=SEQ, global_batch=BATCH, log_every=100, device="cpu",
              n_data=2)
    a = train_loop("minitron-4b", steps=4, ckpt_dir=ckpt_dir, ckpt_every=2,
                   **kw)
    b = train_loop("minitron-4b", steps=6, ckpt_dir=ckpt_dir, ckpt_every=2,
                   **kw)
    c = train_loop("minitron-4b", steps=6, **kw)
    _save(out_dir, "train", rank, (a, b, c))


def _placements_world(rank, world, out_dir):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh, named_shardings, use_mesh
    from repro_torch.models import sharding
    mesh = make_mesh(1, 2, device="cpu")
    res = {}
    with use_mesh(mesh):
        pl = sharding.placements((None, "model"), mesh)
        t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
        dt = distribute_tensor(t, mesh, pl)
        res["local"] = tuple(dt.to_local().shape)
        rep = sharding.maybe_shard(dt, None, None)
        res["replicated"] = (list(rep.placements)
                             == [Replicate(), Replicate()],
                             bool(torch.equal(rep.to_local(), t)))
        res["tree"] = named_shardings(mesh, {"w": ("data", "model"),
                                             "b": None})
        res["shard"] = pl == [Replicate(), Shard(1)]
        res["axes"] = (sharding.active_mesh_axes(),
                       sharding.mesh_axis_size("model"),
                       sharding.mesh_axis_size("pod"))
        # a kernel's op refuses a DTensor
        from repro_torch.kernels import ops
        q = distribute_tensor(torch.zeros(1, 2, 4, 8), mesh,
                              [Replicate(), Replicate()])
        try:
            ops.flash_attention(q, q, q)
            res["refused"] = False
        except TypeError:
            res["refused"] = True
        # compression: a leaf split over `model` takes its scale from
        # the max over its shards; across "pods" (the world here) the
        # int8 values share one scale and are summed exactly
        from repro_torch.optim import compress_grads
        full = torch.tensor([[0.5, -2.0], [1.0, 0.25]]) * (rank + 1)
        shard = full[:, rank:rank + 1].contiguous()
        err = [torch.zeros_like(shard)]
        res["sharded"] = compress_grads(
            [shard], err, sharded=[True],
            group=sharding.axis_group("model"))
        res["pods"] = compress_grads([full], [torch.zeros_like(full)],
                                     pod_group=dist.group.WORLD)
    res["outside"] = (sharding.active_mesh_axes(),
                      sharding.maybe_shard(t, "data", None) is t)
    _save(out_dir, "placements", rank, res)


def test_launch_train_on_two_data_ranks_resumes_bit_equal(tmp_path):
    """``train_loop(n_data=2)`` on a 2-rank gloo world: 4 steps
    checkpointed every 2, then on to 6 from the checkpoint, against 6
    uninterrupted: the resumed losses are the same bits, on both ranks;
    and they are the one-process run's within 2e-4."""
    from repro_torch.launch.train import train_loop
    ckpt = tmp_path / "ckpt"
    _spawn(tmp_path, "_train_world", 2, str(ckpt), str(tmp_path))
    got = [_load(str(tmp_path), "train", r) for r in range(2)]
    (a, b, c), (a1, b1, c1) = got
    assert len(a) == 4 and len(b) == 2 and len(c) == 6
    assert b == c[4:] and (a, b, c) == (a1, b1, c1)
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004",
                                        "step_00000006"]
    one = train_loop("minitron-4b", steps=6, seq_len=SEQ,
                     global_batch=BATCH, log_every=100, device="cpu")
    np.testing.assert_allclose(c, one, rtol=TOL)


def test_placements_and_maybe_shard_on_a_dtensor(tmp_path):
    """A spec's DTensor placements shard the named dimension; maybe_shard
    redistributes a DTensor and leaves a plain tensor, or anything with
    no mesh active, as it is; a kernel's op refuses a DTensor; the int8
    compression of a sharded leaf and across pods."""
    _spawn(tmp_path, "_placements_world", 2, str(tmp_path))
    from torch.distributed.tensor import Replicate, Shard
    for r in range(2):
        res = _load(str(tmp_path), "placements", r)
        assert res["local"] == (4, 3) and res["shard"]
        assert res["replicated"] == (True, True)
        assert res["tree"] == {"w": [Shard(0), Shard(1)],
                               "b": [Replicate(), Replicate()]}
        assert res["axes"] == (("data", "model"), 2, 1)
        assert res["outside"] == ((), True)
        assert res["refused"]
        # rank r holds column r of (r + 1) * base: the max of its leaf is
        # that of both shards, 2 * 2 = 4
        (g,), _ = res["sharded"]
        base = torch.tensor([[0.5, -2.0], [1.0, 0.25]])
        scale = 4.0 / 127
        want = torch.round(base[:, r:r + 1] * (r + 1) / scale) * scale
        torch.testing.assert_close(g, want, rtol=0, atol=1e-7)
        # pods: both scales are the max over the pods (4 / 127), the
        # int8 values sum exactly, and the mean is that sum's half
        (g,), (e,) = res["pods"]
        q = [torch.round(base * (k + 1) / scale) for k in range(2)]
        torch.testing.assert_close(g, (q[0] + q[1]) * (scale / 2), rtol=0,
                                   atol=1e-7)
        torch.testing.assert_close(e, base * (r + 1) - q[r] * scale,
                                   rtol=0, atol=1e-7)


# --------------------------------------------------------------------------
# every family on a (1, 2) mesh against the reference
# --------------------------------------------------------------------------

#: the kernels' entry points whose head counts the families' world records
#: (argument, head dimension)
KERNEL_HEADS = {"flash_attention": (0, 1), "flash_decode": (0, 1),
                "ssd_scan": (0, 2), "ssd_step": (1, 1)}


def _family_batch(cfg, dcfg, step):
    from repro_torch.data.pipeline import batch_for_step
    b = batch_for_step(dcfg, step)
    if cfg.enc_dec:
        b["audio_embed"] = _audio(cfg, step)
    return b


def _audio(cfg, i):
    return np.random.default_rng(i).normal(
        size=(BATCH, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def _families_world(rank, world, ref_path, out_dir):
    """Each FAMILY_ARCHS config (reduced, float32) on a (1, 2) mesh from
    the reference's initial state: FAM_STEPS train steps, then FAM_DEC
    decode steps from the initial parameters; and the head counts that
    reach each kernel's entry point on the mesh."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import lm, train
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_numpy)
    from repro_torch.models.registry import get_arch
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)["family"]
    mesh = make_mesh(1, world, device="cpu")
    heads = {}

    def recording(name, fn):
        arg, dim = KERNEL_HEADS[name]

        def call(*a, **k):
            heads.setdefault(name, set()).add(a[arg].shape[dim])
            return fn(*a, **k)
        return call
    for name in KERNEL_HEADS:
        setattr(ops, name, recording(name, getattr(ops, name)))
    res = {}
    for arch in FAMILY_ARCHS:
        r = ref[arch]
        cfg = get_arch(arch).reduced(dtype="float32")
        if cfg.n_experts:
            cfg = cfg.reduced(capacity_factor=cfg.n_experts / cfg.top_k)
        dcfg = DataConfig(cfg.vocab, SEQ, BATCH)
        heads.clear()
        with use_mesh(mesh):
            state = train_state_from_numpy(cfg, r["s0"], "cpu")
            step = train.make_train_step(cfg)
            ms = []
            for i in range(FAM_STEPS):
                state, m = step(state, _family_batch(cfg, dcfg, i))
                ms.append({k: float(v) for k, v in m.items()})
            params = train_state_to_numpy(cfg, state).params
            model = train_state_from_numpy(cfg, r["s0"], "cpu").params
            with torch.no_grad():
                aux = None
                if cfg.enc_dec:
                    enc = lm.encode_audio(cfg, model,
                                          _audio(cfg, FAM_STEPS))
                    aux = {"cross_kv": lm.cross_kv(cfg, model, enc)}
                cache = lm.init_cache(cfg, BATCH, FAM_DEC, device="cpu")
                logits = [lm.decode_step(cfg, model, cache,
                                         r["tokens"][:, t], t, aux)[0].numpy()
                          for t in range(FAM_DEC)]
                shapes = {k: tuple(v.shape) for k, v in
                          _flat_cache(cache)}
        res[arch] = dict(steps=(ms, params), logits=logits, cache=shapes,
                         heads={k: sorted(v) for k, v in heads.items()})
    _save(out_dir, "families", rank, res)


def _flat_cache(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) if tree[k] is not None
                for x in _flat_cache(tree[k], f"{prefix}{k}.")]
    if hasattr(tree, "_fields"):
        return [x for k in tree._fields
                for x in _flat_cache(getattr(tree, k), f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


@pytest.fixture(scope="module")
def families(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    ref_path = str(tmp / "ref.pkl")
    with open(ref_path, "wb") as f:
        pickle.dump(ref, f)
    _spawn(tmp, "_families_world", 2, ref_path, str(tmp))
    return [_load(str(tmp), "families", r) for r in range(2)]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_trains_on_a_model_axis(ref, families, arch):
    """FAM_STEPS train steps on a (1, 2) mesh from the reference's
    initial state equal the reference's ``jax.jit(make_train_step)``
    without a mesh (its sharded step does not lower under jax 0.9.0, as
    the module doc says), on both ranks: loss and grad norm within 2e-4
    relative, parameters within the module's bound (``2 lr
    sum(lr_scale)`` plus 2e-4 relative: zamba2's zero-initialised LoRA
    B-factors take AdamW steps of lr g / (|g| + eps) on gradients near
    eps, which the sums' order moves).  Every layer runs on this rank's
    half of the heads: the query heads (padded or not), the MLA heads
    and the SSD heads reaching K2, K3 and K4 are half the config's."""
    want_ms, want_p = ref["family"][arch]["steps"]
    ranks = [{("train", arch): ([*f[arch]["steps"][0]],
                                [f[arch]["steps"][1]])} for f in families]
    _hold_train(ranks, arch, want_ms, want_p, FAM_STEPS)
    from repro_torch.models.registry import get_arch
    cfg = get_arch(arch).reduced(dtype="float32")
    for f in families:
        got = f[arch]["heads"]
        for name in ("flash_attention", "flash_decode"):
            if cfg.n_heads:
                assert got[name] == [cfg.padded_heads // 2], (name, got)
        for name in ("ssd_scan", "ssd_step"):
            if cfg.ssm_state:
                assert got[name] == [cfg.ssm_heads // 2], (name, got)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_decodes_on_a_model_axis(ref, families, arch):
    """FAM_DEC decode steps on a (1, 2) mesh, from the initial parameters
    and the caches ``init_cache`` lays out by ``cache_specs`` at the
    mesh's sizes, equal the reference's ``decode_step`` within 2e-4 on
    both ranks; each rank's caches hold half the kv heads (every reduced
    config's kv heads divide 2) and half the SSD heads, and the MLA
    latent whole."""
    from repro_torch.models.registry import get_arch
    cfg = get_arch(arch).reduced(dtype="float32")
    want = ref["family"][arch]["logits"]
    for f in families:
        for got, w in zip(f[arch]["logits"], want):
            np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL)
        for name, shape in f[arch]["cache"].items():
            if name.endswith((".k", ".v")):
                assert shape[-3] == cfg.n_kv_heads // 2, (name, shape)
            elif name.endswith(".ssd"):
                assert shape[-3] == cfg.ssm_heads // 2, (name, shape)
            elif name.endswith(".conv"):
                assert shape[-1] == (cfg.d_inner + 2 * cfg.ssm_state) // 2
            else:
                assert "latent" in name and shape[-1] == (
                    cfg.kv_lora_rank + cfg.d_rope), (name, shape)
