"""The `model` axis as the reference lays it out, on gloo worlds on the
CPU, against the JAX package on a host platform of 4 CPU devices: the
vocabulary split over `model` (the embedding, the LM head, the logits,
the fused cross-entropy, deepseek-v3's mtp loss), sequence parallelism
(``cfg.seq_parallel``) on the per-rank path, and ``moe_a2a`` with the
one-hot dispatch.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (``REF_SCRIPT``):
``moe_a2a`` with ``moe_dispatch="onehot"`` at meshes (1, 2) and (2, 2)
(granite-moe-1b-a400m reduced, float32, at a capacity that drops
tokens); and, for reduced minitron-4b (vocabulary 512, an LM head),
gemma3-27b (tied embedding and head), deepseek-v3-671b (MLA, MoE at a
capacity of E / k, the mtp block) and minitron-4b with the
cross-entropy of the logits (``fused_ce_loss=False``), its train step
jitted without a mesh for 2 steps, ``prefill`` and ``decode_step``.  Its
sharded train step does not lower under jax 0.9.0
(``tests/test_torch_dist.py``), and
without a mesh it is the same function with and without
``seq_parallel`` (the flag only constrains a layout), so the port is
held to that function.

The port runs the same inputs in gloo worlds at meshes (data, model) of
(1, 2) and (2, 2), one spawned process a rank, once with
``seq_parallel`` off and once on (with remat): every rank holds its
(V / n, d) rows of the embedding and its (d, V / n) columns of the head,
each decoder layer sees this rank's S / n positions with the flag, the
losses, grad norms and parameters meet ``tests/test_torch_dist.py``'s
tolerances (2e-4 relative; parameters within ``2 lr sum(lr_scale)`` plus
2e-4 relative) and are the same bits on every rank, prefill and decode
return this rank's columns of the reference's logits within 2e-4 (decode
after a sequence-parallel prefill), and greedy tokens equal the one-rank
run's.  The dry run's view of both (the remat stack a rank, no whole
vocabulary) is held on a fake (1, 16) mesh on the meta device, in a
subprocess without jax.
"""
import json
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
MESHES = [(1, 2), (2, 2)]
#: the archs served (prefill, decode, greedy): the cases' own
ARCHS = ["minitron-4b", "gemma3-27b", "deepseek-v3-671b"]
#: case -> (arch, overrides): an LM head, tied weights, MLA + MoE + mtp,
#: and the cross-entropy of the logits in place of the fused one
CASES = {"minitron-4b": ("minitron-4b", {}),
         "gemma3-27b": ("gemma3-27b", {}),
         "deepseek-v3-671b": ("deepseek-v3-671b", {}),
         "minitron-4b unfused": ("minitron-4b", {"fused_ce_loss": False})}
TOL = 2e-4
LR = 3e-4
SEQ, BATCH, STEPS = 16, 4, 2
PROMPT, GEN = 6, 4

REF_SCRIPT = r'''
import pickle, sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from repro.data import pipeline as jpipe
from repro.launch.mesh import make_mesh
from repro.models import lm as jlm, moe as jmoe, train as jtrain
from repro.models.registry import get_arch

MESHES, CASES = %r, %r
SEQ, BATCH, STEPS, PROMPT, GEN = %d, %d, %d, %d, %d
npy = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {"moe": {}, "arch": {}}

cfg = get_arch("granite-moe-1b-a400m").reduced(
    dtype="float32", moe_dispatch="onehot", capacity_factor=0.5)
p = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
x = np.random.default_rng(1).normal(size=(4, 8, cfg.d_model)).astype(
    np.float32)
out["moe_in"] = (npy(p), x)
for m in MESHES:
    out["moe"][m] = np.asarray(jmoe.moe_a2a(p, jnp.asarray(x), cfg,
                                            mesh=make_mesh(*m)))

def config(arch, over):
    c = get_arch(arch).reduced(dtype="float32", **over)
    if c.n_experts:         # no token drops: a2a is then the dense dispatch
        c = c.reduced(capacity_factor=c.n_experts / c.top_k, **over)
    return c

for case, (arch, over) in CASES.items():
    c = config(arch, over)
    st = jtrain.init_train_state(c, jax.random.PRNGKey(0))
    s0 = npy(st)
    dcfg = jpipe.DataConfig(vocab=c.vocab, seq_len=SEQ, global_batch=BATCH)
    batches = [jpipe.batch_for_step(dcfg, i) for i in range(STEPS)]
    j = jax.jit(jtrain.make_train_step(c))
    ms = []
    for b in batches:
        st, met = j(st, b)
        ms.append({k: float(v) for k, v in met.items()})
    params = jax.tree_util.tree_map(jnp.asarray, s0.params)
    toks = np.random.default_rng(7).integers(0, c.vocab, (BATCH, PROMPT))
    pre = np.asarray(jlm.prefill(c, params, {"tokens": jnp.asarray(toks)}))
    cache = jlm.init_cache(c, BATCH, PROMPT + GEN)
    step = jax.jit(partial(jlm.decode_step, c))
    logits = []
    for t in range(PROMPT):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t]),
                         jnp.int32(t))
        logits.append(np.asarray(lg))
    out["arch"][case] = {"s0": s0, "batches": batches,
                         "steps": (ms, npy(st.params)), "tokens": toks,
                         "prefill": pre, "decode": logits}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
''' % (MESHES, CASES, SEQ, BATCH, STEPS, PROMPT, GEN)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
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


def _config(arch, **overrides):
    from repro_torch.models.registry import get_arch
    cfg = get_arch(arch).reduced(dtype="float32", **overrides)
    if cfg.n_experts:
        cfg = cfg.reduced(capacity_factor=cfg.n_experts / cfg.top_k,
                          **overrides)
    return cfg


def _recording_layers(lm, seen):
    """Wrap ``lm._decoder_layer`` so that it records the positions of the
    stream it is given in a full-sequence pass (no cache)."""
    inner = lm._decoder_layer

    def layer(p, h, cfg, positions, *a, **k):
        if k.get("kv_cache") is None and len(a) < 3:
            seen.add((h.shape[1], positions.shape[1]))
        return inner(p, h, cfg, positions, *a, **k)
    lm._decoder_layer = layer


def _mesh_world(rank, world, nd, nm, ref_path, out_dir):
    """Every check of one mesh on this rank; results to ``out_dir``."""
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm, sharding, train
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_numpy)
    from repro_torch.models.moe import MoE, moe_a2a
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    mesh = make_mesh(nd, nm, device="cpu")
    res = {}
    seen = set()
    _recording_layers(lm, seen)
    with use_mesh(mesh), torch.no_grad():
        rd = sharding.axis_rank("data")
        rows = slice(rd * BATCH // nd, (rd + 1) * BATCH // nd)
        # moe_a2a with the one-hot dispatch, tokens dropped per shard
        from repro_torch.models.registry import get_arch
        cfg = get_arch("granite-moe-1b-a400m").reduced(
            dtype="float32", moe_dispatch="onehot", capacity_factor=0.5)
        tree, x = ref["moe_in"]
        p = MoE(cfg, torch.float32, "cpu")
        p.router.copy_(torch.from_numpy(tree["router"]))
        for k in ("w_in", "w_gate", "w_out"):
            w = getattr(p.experts, k)
            w.copy_(torch.from_numpy(tree["experts"][k]))
            sharding.shard_tensor(w, ("model", None, None))
        res["moe"] = (rows, moe_a2a(p, torch.from_numpy(x[rows]),
                                    cfg).numpy(), int(p.dropped))
        # greedy over a vocabulary split over `model`: the lowest index
        # among equal maxima, as torch.argmax of the whole rows
        rm = sharding.axis_rank("model")
        res["coords"] = (rd, rm)
        tie = torch.zeros(3, 4)
        tie[0, 1] = 5.0                         # every rank: index 1
        tie[1, 3 - rm] = 7.0                    # rank 0: 3; rank 1: 2
        tie[2, rm] = 1.0 if rm else 2.0         # rank 0 holds the max
        res["argmax"] = lm.greedy(_config("minitron-4b"), tie).tolist()
    for case, (arch, base) in CASES.items():
        r = ref["arch"][case]
        for sp in (False, True):
            over = dict(base, seq_parallel=True, remat=True) if sp else base
            cfg = _config(arch, **over)
            seen.clear()
            with use_mesh(mesh):
                state = train_state_from_numpy(cfg, r["s0"], "cpu")
                shapes = {n: tuple(q.shape) for n, q in
                          state.params.named_parameters()
                          if n in ("embed", "lm_head")}
                step = train.make_train_step(cfg)
                ms = []
                for b in r["batches"]:
                    state, met = step(state, {k: v[rows]
                                              for k, v in b.items()})
                    ms.append({k: float(v) for k, v in met.items()})
                params = train_state_to_numpy(cfg, state).params
                train_seen = set(seen)
                model = train_state_from_numpy(cfg, r["s0"], "cpu").params
                # a batch of 4 rows is served in the long-context layout
                # over `data` (registry.seq_over_data): every rank all rows
                toks = r["tokens"]
                with torch.no_grad():
                    pre = lm.prefill(cfg, model, {"tokens": toks})
                    cache = lm.init_cache(cfg, BATCH, PROMPT + GEN,
                                          device="cpu")
                    dec = [lm.decode_step(cfg, model, cache, toks[:, t],
                                          t)[0].numpy()
                           for t in range(PROMPT)]
                    whole = lm.gather_vocab(cfg, pre).numpy()
                    g = generate(cfg, model, toks, GEN).tokens
            res[(case, sp)] = dict(steps=(ms, params), shapes=shapes,
                                   seen=train_seen, prefill=pre.numpy(),
                                   prefill_whole=whole, decode=dec,
                                   greedy=g)
        # the one-rank run's greedy tokens
        with torch.no_grad():
            model = train_state_from_numpy(cfg, r["s0"], "cpu").params
            res[(case, "one rank")] = generate(cfg, model, toks, GEN).tokens
    with open(os.path.join(out_dir, f"mesh{nd}x{nm}_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """mesh -> [each rank's results]."""
    tmp = tmp_path_factory.mktemp("worlds")
    ref_path = str(tmp / "ref.pkl")
    with open(ref_path, "wb") as f:
        pickle.dump(ref, f)
    out = {}
    for nd, nm in MESHES:
        store = str(tmp / f"store_{nd}x{nm}_{os.getpid()}")
        mp.spawn(_rank_main, args=(nd * nm, store, "_mesh_world",
                                   (nd, nm, ref_path, str(tmp))),
                 nprocs=nd * nm, join=True)
        ranks = []
        for r in range(nd * nm):
            with open(tmp / f"mesh{nd}x{nm}_{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out[(nd, nm)] = ranks
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_a2a_onehot_matches_reference(ref, worlds, mesh):
    """``moe_a2a`` with the one-hot dispatch, where tokens drop on each
    shard: every rank's rows within 2e-4 of the reference's one-hot
    ``moe_a2a`` at the same mesh, and some assignments dropped."""
    want = ref["moe"][mesh]
    for rows, got, dropped in (r["moe"] for r in worlds[mesh]):
        np.testing.assert_allclose(got, want[rows], atol=TOL, rtol=TOL)
        assert dropped > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_greedy_takes_the_lowest_index_among_equal_maxima(worlds, mesh):
    """``lm.greedy`` over a vocabulary of 2 x 4 split over `model`: a max
    that both slices hold at local index 1 gives 1, a max at 3 on rank 0
    and 6 on rank 1 gives 3, a max on rank 0 alone gives its index."""
    for r in worlds[mesh]:
        assert r["argmax"] == [1, 3, 0]


def _hold_train(ranks, key, want_ms, want_p):
    losses = {tuple(m["loss"] for m in r[key]["steps"][0]) for r in ranks}
    assert len(losses) == 1, losses         # the same bits on every rank
    ms, params = ranks[0][key]["steps"]
    for got, want in zip(ms, want_ms):
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


@pytest.mark.parametrize("sp", [False, True], ids=["vocab", "seq_parallel"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh", MESHES)
def test_train_steps_on_a_split_vocabulary(ref, worlds, mesh, case, sp):
    """Two train steps with the vocabulary split over `model` (and, with
    `sp`, the residual stream split by positions) against the
    reference's ``jax.jit(make_train_step)`` (the unfused case: the
    cross-entropy of the logits, ``layers.vocab_cross_entropy`` on this
    rank's columns): loss, grad norm and the
    parameters after the steps within the tolerances, the same loss
    bits on every rank; each rank holds (V / n, d) embedding rows and
    (d, V / n) head columns; with `sp` every decoder layer's stream in
    the step holds S / n positions of the S the attention sees."""
    from repro_torch.models.registry import get_arch
    cfg = get_arch(CASES[case][0]).reduced()
    ms, p = ref["arch"][case]["steps"]
    _hold_train(worlds[mesh], (case, sp), ms, p)
    nm = mesh[1]
    for r in worlds[mesh]:
        shapes = r[(case, sp)]["shapes"]
        assert shapes["embed"] == (cfg.vocab // nm, cfg.d_model)
        if not cfg.tie_embeddings:
            assert shapes["lm_head"] == (cfg.d_model, cfg.vocab // nm)
        want = {(SEQ // nm if sp else SEQ, SEQ)}
        assert r[(case, sp)]["seen"] == want


@pytest.mark.parametrize("sp", [False, True], ids=["vocab", "seq_parallel"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_prefill_and_decode_return_the_rank_vocab_slice(ref, worlds, mesh,
                                                        arch, sp):
    """``prefill`` (sequence-parallel with `sp`), then ``decode_step``
    over the prompt from a new cache (4 rows: every rank serves all of
    them, the long-context layout over `data`): each rank returns its
    (B, V / n) columns of the reference's logits within 2e-4, as the
    reference's out-specs lay them out; ``gather_vocab`` gives the whole
    rows."""
    r_ref = ref["arch"][arch]
    nm = mesh[1]
    V = r_ref["prefill"].shape[-1]
    for r in worlds[mesh]:
        got = r[(arch, sp)]
        cols = slice(r["coords"][1] * V // nm, (r["coords"][1] + 1) * V // nm)
        assert got["prefill"].shape == (BATCH, V // nm)
        np.testing.assert_allclose(got["prefill"], r_ref["prefill"][:, cols],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["prefill_whole"], r_ref["prefill"],
                                   atol=TOL, rtol=TOL)
        for g, w in zip(got["decode"], r_ref["decode"]):
            np.testing.assert_allclose(g, w[:, cols], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_greedy_tokens_equal_the_one_rank_run(worlds, mesh, arch):
    """``launch.serve.generate`` on the split vocabulary picks the tokens
    the one-rank run picks, with and without the sequence-parallel
    flag, on every rank."""
    for r in worlds[mesh]:
        want = r[(arch, "one rank")]
        for sp in (False, True):
            np.testing.assert_array_equal(r[(arch, sp)]["greedy"], want)


# --------------------------------------------------------------------------
# the dry run's view: a fake (1, 16) mesh on the meta device
# --------------------------------------------------------------------------

DRY_SCRIPT = r'''
import dataclasses, json, sys, warnings
warnings.filterwarnings("ignore")
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from repro_torch.analysis.cost import CostCounter
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, use_mesh
from repro_torch.models import lm, registry, train

V = 16 * 97
NM, B, S = 16, 2, 256


class Widths(TorchDispatchMode):
    """Every op's output dimensions."""
    def __init__(self):
        super().__init__()
        self.dims = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.dims.update(t.shape)
        return out


def config(arch, layers, sp):
    """Reduced `arch` with 16 heads of 16 (the axis splits them)."""
    c = registry.get_arch(arch).reduced(vocab=V, remat=True,
                                        seq_parallel=sp)
    return dataclasses.replace(c, n_layers=layers, n_heads=NM,
                               n_kv_heads=NM, d_head=16)


def batch(c):
    t = torch.empty((B, S), dtype=torch.int32, device="meta")
    return {"tokens": t, "labels": t}


dryrun.fake_world(NM)
mesh = make_mesh(1, NM, device="cpu")
out = {"saved": {}, "whole_vocab": {}}
with use_mesh(mesh):
    for arch in ("minitron-4b", "gemma3-27b"):
        for sp in (False, True):
            saved = []
            for layers in (2, 4):
                c = config(arch, layers, sp)
                model = registry.abstract_params(c)
                from repro_torch.models import sharding
                sharding.shard_params(c, model)
                model.requires_grad_(True)
                with CostCounter(arguments=model) as cc:
                    loss = lm.loss_fn(c, model, batch(c))
                    saved.append(cc.live_bytes)
                    del loss
            out["saved"]["%%s %%d" %% (arch, sp)] = saved
        c = config(arch, 2, True)
        st = train.init_train_state(c, device="meta")
        step = train.make_train_step(c)
        cache = lm.init_cache(c, B, S, device="meta")
        w = Widths()
        with w:
            step(st, batch(c))
            with torch.no_grad():
                lm.prefill(c, st.params, batch(c))
                lm.decode_step(c, st.params, cache,
                               torch.empty((B,), dtype=torch.int32,
                                           device="meta"), S - 1)
        out["whole_vocab"][arch] = V in w.dims
        out["slice_seen"] = V // NM in w.dims
json.dump(out, open(sys.argv[1], "w"))
'''.replace("%%", "%")


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dry") / "dry.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", DRY_SCRIPT, path], env=env,
                   cwd=ROOT, check=True, timeout=600)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ["minitron-4b", "gemma3-27b"])
def test_dry_run_remat_stack_falls_by_n_model(dry, arch):
    """On a fake (1, 16) mesh on the meta device (batch 2 x 256, remat,
    16 heads):
    what the loss's forward leaves alive for the backward grows by
    B S d x 2 bytes a decoder layer without ``seq_parallel`` (each
    layer's input, the remat stack) and by a sixteenth of that with it."""
    from repro_torch.models.registry import get_arch
    d = get_arch(arch).reduced().d_model
    per = {}
    for sp in (False, True):
        two, four = dry["saved"][f"{arch} {int(sp)}"]
        per[sp] = (four - two) / 2
    assert per[False] == 2 * 256 * d * 2          # bfloat16
    assert per[True] * 16 == per[False]


@pytest.mark.parametrize("arch", ["minitron-4b", "gemma3-27b"])
def test_dry_run_gathers_no_whole_vocabulary(dry, arch):
    """The same mesh, a vocabulary of 16 x 97 split over `model`: no op of
    a train step, a prefill or a decode step makes a tensor with a
    dimension of the whole vocabulary (no table, head or logits in
    full); the 97-wide slices appear."""
    assert dry["whole_vocab"][arch] is False
    assert dry["slice_seen"]
