"""FSDP over `data` (``cfg.fsdp``) on gloo worlds on the CPU, against the
JAX package's single-device train step.

deepseek-v3-671b and nemotron-4-340b set ``fsdp=True``: their specs
split parameters over `data` as well as `model`
(``registry.state_specs``).  The reduced configs (float32, ``fsdp=True``;
deepseek-v3 at a capacity factor of E / k, where no token drops, so that
``moe_a2a`` on a model axis is the dense dispatch's function) train for
three steps from the reference's initial state on meshes (data 2, model
1) and (data 2, model 2), one process a rank (``torch.multiprocessing
.spawn``, a ``FileStore`` under the test's tmp dir, as
``tests/test_torch_dist.py``), each data rank on its rows, with the
default options and with ``n_micro=2, compress_grads=True``.  Each is
held to the reference's ``jax.jit(make_train_step)`` without a mesh:
loss, grad norm and lr scale within 2e-4 relative, parameters within
``2 lr sum(lr_scale)`` plus 2e-4 relative (``_hold_train`` of
``tests/test_torch_dist.py``), the same loss bits on every rank.  Every
rank holds half of each parameter the spec splits over `data`; a
checkpoint saved on (2, 2) loads on one process, bit-equal.

On the same worlds, the long-context layout: a decode batch of fewer
than 8 rows on a data axis above 1 keeps every row on every rank and
splits each kv / latent cache's positions over `data` (the reference's
``cache_specs`` for ``long_500k``); eight decode steps of reduced
minitron-4b (GQA), zamba2-2.7b (its shared block), gemma3-27b (rings
and the global cache) and deepseek-v3 (MLA, FSDP) cross from one data
rank's positions into the other's, and their logits are held to the
reference's ``decode_step`` without a mesh within 2e-4.
"""
import copy
import io
import os
import pickle

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models import train as jtrain
from repro.models.registry import get_arch as jget_arch

MESHES = [(2, 1), (2, 2)]
ARCHS = ["deepseek-v3-671b", "nemotron-4-340b"]
OPTS = {"default": {}, "micro2-compress": {"n_micro": 2,
                                           "compress_grads": True}}
TOL = 2e-4
LR = 3e-4                           # AdamWConfig().lr
SEQ, BATCH, STEPS = 16, 4, 3
DEC_ARCHS = ["minitron-4b", "zamba2-2.7b", "gemma3-27b", "deepseek-v3-671b"]
DEC_B, DEC_LEN, DEC_STEPS = 2, 12, 8


def _dec_cfg(get_arch, arch):
    return _cfg(get_arch, arch) if arch == "deepseek-v3-671b" else \
        get_arch(arch).reduced(dtype="float32")


def _cfg(get_arch, arch):
    cfg = get_arch(arch).reduced(dtype="float32", fsdp=True)
    if cfg.n_experts:
        cfg = cfg.reduced(dtype="float32", fsdp=True,
                          capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """(arch, opts) -> the reference's initial state, batches, and STEPS
    steps of ``jax.jit(make_train_step)`` without a mesh."""
    npy = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    out = {}
    for arch in ARCHS:
        cfg = _cfg(jget_arch, arch)
        for name, kw in OPTS.items():
            opts = jtrain.TrainOptions(**kw)
            st = jtrain.init_train_state(cfg, jax.random.PRNGKey(0),
                                         opts=opts)
            s0 = npy(st)
            step = jax.jit(jtrain.make_train_step(cfg, opts=opts))
            dcfg = jpipe.DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                    global_batch=BATCH)
            batches = [jpipe.batch_for_step(dcfg, i) for i in range(STEPS)]
            ms = []
            for b in batches:
                st, m = step(st, b)
                ms.append({k: float(v) for k, v in m.items()})
            out[(arch, name)] = dict(s0=s0, batches=batches, metrics=ms,
                                     params=npy(st.params))
    for arch in DEC_ARCHS:
        cfg = _dec_cfg(jget_arch, arch)
        params = jlm.init_params(cfg, jax.random.PRNGKey(3))
        toks = np.random.default_rng(4).integers(
            0, cfg.vocab, (DEC_B, DEC_STEPS)).astype(np.int32)
        cache = jlm.init_cache(cfg, DEC_B, DEC_LEN)
        step = jax.jit(partial(jlm.decode_step, cfg))
        logits = []
        for t in range(DEC_STEPS):
            lg, cache = step(params, cache, jnp.asarray(toks[:, t]),
                             jnp.int32(t))
            logits.append(np.asarray(lg))
        out[("decode", arch)] = dict(params=npy(params), tokens=toks,
                                     logits=logits)
    return out


def _rank_main(rank, world, store_path, fn_name, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        globals()[fn_name](rank, world, *args)
    finally:
        dist.destroy_process_group()


#: the copies a long-context cache is decoded on after half its steps
COPIES = ("clone", "to", "deepcopy", "torch.save")


def _copy_cache(how, cache):
    """A copy of decode cache `cache` made `how` (``COPIES``)."""
    from repro_torch.models import sharding
    if how == "deepcopy":
        return copy.deepcopy(cache)
    if how == "torch.save":
        buf = io.BytesIO()
        torch.save(cache, buf)
        buf.seek(0)
        return torch.load(buf, weights_only=False)
    if how == "to":
        return sharding.map_with_path(
            lambda p, t: t.to(torch.float64).to(t.dtype), cache)
    return sharding.map_with_path(lambda p, t: t.clone(), cache)


def _fsdp_world(rank, world, nd, nm, ref_path, out_dir):
    """Every (arch, options) case on this rank of an (nd, nm) mesh; on
    (2, 2) rank 0 also checkpoints deepseek-v3's state after the default
    run."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import sharding, train
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_host,
                                            train_state_to_numpy)
    from repro_torch.models.registry import get_arch
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    from repro_torch.models import lm
    from repro_torch.models.attention import SeqOverData
    from repro_torch.models.convert import params_from_numpy
    mesh = make_mesh(nd, nm, device="cpu")
    res = {}
    with use_mesh(mesh), torch.no_grad():
        for arch in DEC_ARCHS:
            r = ref.pop(("decode", arch))
            cfg = _dec_cfg(get_arch, arch)
            model = sharding.shard_params(
                cfg, params_from_numpy(cfg, r["params"], "cpu"))
            cache = lm.init_cache(cfg, DEC_B, DEC_LEN, "cpu")
            split = []
            sharding.map_with_path(
                lambda p, t: split.append(isinstance(t, SeqOverData)),
                cache)
            # the whole rows of each step's logits (this rank's
            # vocabulary slice where the model axis splits it)
            logits = [lm.gather_vocab(cfg, lm.decode_step(
                cfg, model, cache, r["tokens"][:, t], t)[0]).numpy()
                      for t in range(DEC_STEPS)]
            copied = {}
            for how in COPIES:
                cache = lm.init_cache(cfg, DEC_B, DEC_LEN, "cpu")
                copied[how] = []
                for t in range(DEC_STEPS):
                    if t == DEC_STEPS // 2:
                        cache = _copy_cache(how, cache)
                    copied[how].append(lm.gather_vocab(cfg, lm.decode_step(
                        cfg, model, cache, r["tokens"][:, t], t)[0]).numpy())
            res[("decode", arch)] = dict(logits=logits, split=split,
                                         copied=copied)
    with use_mesh(mesh):
        rd = sharding.axis_rank("data")
        rows = slice(rd * BATCH // nd, (rd + 1) * BATCH // nd)
        for (arch, name), r in ref.items():
            cfg = _cfg(get_arch, arch)
            state = train_state_from_numpy(cfg, r["s0"], "cpu")
            params = list(state.params.parameters())
            split = [(tuple(p.shape), sharding.full_shape(p),
                      sharding.data_dim(p), p._spec) for p in params]
            step = train.make_train_step(
                cfg, opts=train.TrainOptions(**OPTS[name]))
            ms = []
            for b in r["batches"]:
                state, m = step(state, {k: v[rows] for k, v in b.items()})
                ms.append({k: float(v) for k, v in m.items()})
            res[(arch, name)] = dict(
                metrics=ms, split=split,
                params=train_state_to_numpy(cfg, state).params)
            if (nd, nm) == (2, 2) and (arch, name) == (ARCHS[0],
                                                       "default"):
                host = train_state_to_host(cfg, state)
                res["ckpt_state"] = train_state_to_numpy(cfg, state)
                if rank == 0:
                    CheckpointManager(os.path.join(out_dir, "ckpt")).save(
                        STEPS, host)
                dist.barrier()
    with open(os.path.join(out_dir, f"fsdp{nd}x{nm}_{rank}.pkl"),
              "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """mesh -> [each rank's results], and the directory of the (2, 2)
    world's checkpoint."""
    tmp = tmp_path_factory.mktemp("fsdp")
    ref_path = str(tmp / "ref.pkl")
    with open(ref_path, "wb") as f:
        pickle.dump(ref, f)
    out = {}
    for nd, nm in MESHES:
        store = str(tmp / f"store_{nd}x{nm}_{os.getpid()}")
        mp.spawn(_rank_main, args=(nd * nm, store, "_fsdp_world",
                                   (nd, nm, ref_path, str(tmp))),
                 nprocs=nd * nm, join=True)
        ranks = []
        for r in range(nd * nm):
            with open(str(tmp / f"fsdp{nd}x{nm}_{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        out[(nd, nm)] = ranks
    out["ckpt_dir"] = str(tmp / "ckpt")
    return out


@pytest.mark.parametrize("opts", list(OPTS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_fsdp_train_steps_match_the_reference(ref, worlds, mesh, arch, opts):
    want = ref[(arch, opts)]
    ranks = [r[(arch, opts)] for r in worlds[mesh]]
    assert len({r["metrics"][-1]["loss"] for r in ranks}) == 1
    got = ranks[0]
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm", "lr_scale"):
            assert abs(g[k] - w[k]) <= TOL * max(abs(w[k]), 1e-30), \
                (k, g[k], w[k])
    atol = 2 * LR * sum(m["lr_scale"] for m in want["metrics"])
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got["params"])[0],
            jax.tree_util.tree_flatten_with_path(want["params"])[0]):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=atol,
                                   rtol=TOL, err_msg=str(path))


@pytest.mark.parametrize("mesh", MESHES)
def test_fsdp_splits_parameters_over_data(worlds, mesh):
    """Every parameter whose spec names `data` holds half of that
    dimension on each rank (``shard_tensor`` no longer raises for it),
    over `model` too where the spec says so; both archs split some."""
    nd, nm = mesh
    for arch in ARCHS:
        split = worlds[mesh][0][(arch, "default")]["split"]
        n_data = 0
        for local, full, dd, spec in split:
            names = [n for s in spec
                     for n in (s if isinstance(s, tuple) else (s,))]
            assert (dd is not None) == ("data" in names)
            want = list(full)
            for d, s in enumerate(spec):
                if s == "data":
                    want[d] //= nd
                elif s == "model":
                    want[d] //= nm
            assert list(local) == want, (spec, local, full)
            n_data += dd is not None
        assert n_data > 0, arch


def test_fsdp_checkpoint_from_2x2_loads_on_one_process_bit_equal(worlds):
    """deepseek-v3's state after three FSDP steps on (2, 2), saved by rank
    0 from the gathered state, restores in a process without a mesh
    into the same parameters, moments and step, bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import train
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_host,
                                            train_state_to_numpy)
    from repro_torch.models.registry import get_arch
    cfg = _cfg(get_arch, ARCHS[0])
    like = train_state_to_host(cfg, train.init_train_state(cfg, 1, "cpu"))
    tree, step, _ = CheckpointManager(worlds["ckpt_dir"]).restore(like)
    assert step == STEPS
    got = train_state_to_numpy(cfg, train_state_from_numpy(cfg, tree,
                                                           "cpu"))
    want = worlds[(2, 2)][0]["ckpt_state"]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("arch", DEC_ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_long_context_layout_decodes_as_the_reference(ref, worlds, mesh,
                                                      arch):
    """Eight decode steps of 2 rows with a 12-position cache split over
    the 2 data ranks (6 each; rings too): every rank's logits within
    2e-4 of the reference's ``decode_step`` without a mesh."""
    want = ref[("decode", arch)]["logits"]
    for r in worlds[mesh]:
        got = r[("decode", arch)]
        assert any(got["split"]), "no cache split over `data`"
        for t, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"step {t}")


@pytest.mark.parametrize("how", COPIES)
@pytest.mark.parametrize("arch", DEC_ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_long_context_cache_decodes_the_same_after_a_copy(ref, worlds, mesh,
                                                          arch, how):
    """The long-context decode of
    ``test_long_context_layout_decodes_as_the_reference`` with its cache
    replaced half way by a copy (a clone of each leaf, a round trip
    through float64, ``copy.deepcopy``, ``torch.save`` / ``torch.load``):
    the copy keeps the layout, and every step's logits stay within 2e-4
    of the reference's."""
    want = ref[("decode", arch)]["logits"]
    for r in worlds[mesh]:
        got = r[("decode", arch)]["copied"][how]
        for t, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"step {t}")
