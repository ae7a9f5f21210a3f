"""The port's checkpoints (``repro_torch.checkpoint.manager``): a bit-exact
round trip, bf16 included; atomic commit (a step without a manifest is
skipped) and the fall-back past a corrupt shard; asynchronous saves that
copy; and the on-disk layout shared with the JAX package: a reference
save restores in the port and a port save restores in the reference, with
equal arrays, and the next step of each package from the other's
checkpoint equals its own."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data import pipeline as jpipe
from repro.models import train as jtrain
from repro.models.registry import get_arch as jget_arch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import train as ttrain
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_host,
                                        train_state_to_numpy)
from repro_torch.models.registry import get_arch

ARCH = "minitron-4b"


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree):
    return jax.tree_util.tree_leaves(tree)


def _port_state(dtype, compress=False):
    cfg = get_arch(ARCH).reduced(dtype=dtype)
    opts = ttrain.TrainOptions(compress_grads=compress)
    state = ttrain.init_train_state(cfg, 0, "cpu", opts=opts)
    step = ttrain.make_train_step(cfg, opts=opts)
    b = jpipe.batch_for_step(jpipe.DataConfig(cfg.vocab, 16, 2), 0)
    state, _ = step(state, b)            # nonzero moments and feedback
    return cfg, state


@pytest.mark.parametrize("dtype,compress", [("bfloat16", False),
                                            ("float32", True)])
def test_round_trip_is_bit_exact(tmp_path, dtype, compress):
    cfg, state = _port_state(dtype, compress)
    mgr = CheckpointManager(str(tmp_path))
    host = train_state_to_host(cfg, state)
    mgr.save(1, host, meta={"loss": 1.5})
    tree, step, meta = mgr.restore(host)
    assert step == 1 and meta == {"loss": 1.5}
    want, got = _flat(host), _flat(tree)
    assert len(want) == len(got) == json.load(open(
        tmp_path / "step_00000001" / "MANIFEST.json"))["n_leaves"]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back = train_state_from_numpy(cfg, tree, "cpu")
    for a, b in zip(back.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(back.opt.m + back.opt.v, state.opt.m + state.opt.v):
        assert torch.equal(a, b)
    assert int(back.opt.step) == 1
    assert (back.error_fb is None) == (not compress)
    dtypes = json.load(open(tmp_path / "step_00000001" /
                            "MANIFEST.json"))["dtypes"]
    assert ("bfloat16" in dtypes) == (dtype == "bfloat16")


def test_uncommitted_step_is_skipped_and_corrupt_shard_falls_back(tmp_path):
    cfg, state = _port_state("float32")
    mgr = CheckpointManager(str(tmp_path), keep=5)
    host = train_state_to_host(cfg, state)
    mgr.save(4, host)
    mgr.save(8, host)
    # a step killed mid-save: its directory has a shard but no manifest
    os.makedirs(tmp_path / "step_00000012")
    np.savez(tmp_path / "step_00000012" / "shard_0.npz", leaf_0=np.zeros(1))
    os.makedirs(tmp_path / "step_00000016.tmp0")
    assert mgr.latest_step() == 8
    # flip a byte of step 8's shard: its checksum fails, step 4 restores
    shard = tmp_path / "step_00000008" / "shard_0.npz"
    blob = bytearray(shard.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    shard.write_bytes(bytes(blob))
    _, step, _ = mgr.restore(host)
    assert step == 4
    with pytest.raises(FileNotFoundError):
        mgr.restore(host, step=8)


def test_keep_collects_old_steps(tmp_path):
    cfg, state = _port_state("float32")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    host = train_state_to_host(cfg, state)
    for s in (1, 2, 3):
        mgr.save(s, host)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]


def test_save_async_copies_a_cpu_state(tmp_path):
    """The snapshot is taken when save_async returns: an in-place update
    of the state after it (the next step's) does not reach the file, also
    for host tensors, which ``.cpu()`` would not copy."""
    cfg, state = _port_state("float32")
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": state.params.embed.detach(), "m": state.opt.m[0]}
    before = {k: v.clone() for k, v in tree.items()}
    mgr.save_async(1, tree)
    with torch.no_grad():
        state.params.embed.add_(1.0)
        state.opt.m[0].add_(1.0)
    mgr.wait()
    got, _, _ = mgr.restore(tree)
    for k in tree:
        assert torch.equal(got[k], before[k])


def _reference_state(jcfg):
    return jtrain.init_train_state(jcfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_packages_both_ways(tmp_path, dtype):
    """A reference step's checkpoint restores in the port, and the port's
    save of it restores in the reference, with equal arrays; then each
    package's next step from the restored state equals the other's."""
    _cross_both_ways(tmp_path, ARCH, dtype)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-1b-a400m"])
def test_checkpoints_of_the_other_trees_cross_both_ways(tmp_path, arch):
    """The same for the hybrid tree (groups.ssm stacked over (G, R),
    groups.lora over (G,), the unstacked shared block) and the MoE tree
    (router and stacked experts), in float32."""
    _cross_both_ways(tmp_path, arch, "float32")


def _cross_both_ways(tmp_path, arch, dtype):
    jcfg = jget_arch(arch).reduced(dtype=dtype)
    tcfg = get_arch(arch).reduced(dtype=dtype)
    jstep = jax.jit(jtrain.make_train_step(jcfg))
    tstep = ttrain.make_train_step(tcfg)
    dcfg = jpipe.DataConfig(jcfg.vocab, 16, 2)
    jstate, _ = jstep(_reference_state(jcfg), jpipe.batch_for_step(dcfg, 0))

    JManager(str(tmp_path / "ref")).save(1, jstate)
    like = train_state_to_host(tcfg, ttrain.init_train_state(tcfg, 0, "cpu"))
    tree, step, _ = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert step == 1
    tstate = train_state_from_numpy(tcfg, tree, "cpu")
    for got, want in zip(_flat(train_state_to_numpy(tcfg, tstate)),
                         _flat(jstate)):
        assert got.dtype == np.asarray(want).dtype
        assert np.array_equal(got, np.asarray(want))

    CheckpointManager(str(tmp_path / "port")).save(
        1, train_state_to_host(tcfg, tstate))
    back, step, _ = JManager(str(tmp_path / "port")).restore(jstate)
    assert step == 1
    for got, want in zip(_flat(back), _flat(jstate)):
        assert got.dtype == np.asarray(want).dtype
        assert np.array_equal(got, np.asarray(want))

    b = jpipe.batch_for_step(dcfg, 1)
    back = jax.tree_util.tree_map(jax.numpy.asarray, back)
    _, jm = jstep(back, b)
    _, tm = tstep(tstate, b)
    for key in ("loss", "grad_norm"):
        tol = 2e-4 if dtype == "float32" else 2e-2
        assert abs(float(tm[key]) - float(jm[key])) <= tol * abs(
            float(jm[key])), key
    assert int(tm["step"]) == int(jm["step"]) == 2
