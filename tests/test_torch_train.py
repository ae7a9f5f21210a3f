"""The port's training step and loop (``repro_torch.models.train``,
``repro_torch.launch.train``) against the JAX package on the CPU.

Reduced minitron-4b, qwen2-vl-2b, mamba2-370m, zamba2-2.7b,
granite-moe-1b-a400m and whisper-tiny (its batches carry audio
embeddings) in float32 start from the reference's
own initial state (carried across with
``models.convert.train_state_from_numpy``) and take 3 steps on the
batches ``batch_for_step`` gives, against ``jax.jit(make_train_step(cfg,
opts=...))`` called without a mesh, as ``tests/test_archs.py`` calls it
(the reference's ``train_loop`` fails on this tree).  Tolerances: loss,
grad norm and lr scale within 2e-4 relative; parameters within
``2 lr sum(lr_scale)`` absolute (the most AdamW moves an element in the
steps, which is what an element whose gradient sits at zero and flips
sign between the two packages can differ by) plus 2e-4 relative.
"""
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.models import train as jtrain
from repro.models.registry import get_arch as jget_arch
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import train_loop
from repro_torch.models import lm as tlm
from repro_torch.models import train as ttrain
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.registry import get_arch

LR = 3e-4                       # AdamWConfig().lr on both sides
RTOL = 2e-4


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_params_close(got, want, atol):
    for (path, a), (_, b) in zip(_leaves_with_paths(got),
                                 _leaves_with_paths(want)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=atol,
                                   rtol=RTOL, err_msg=str(path))


def _batch(cfg, dcfg, step):
    """``batch_for_step``'s tokens and labels and, for whisper, the audio
    embeddings (B, n_audio_frames, d) float32 drawn from the step."""
    b = jpipe.batch_for_step(dcfg, step)
    if cfg.enc_dec:
        b["audio_embed"] = np.random.default_rng(step).normal(
            size=(dcfg.global_batch, cfg.n_audio_frames, cfg.d_model)
        ).astype(np.float32)
    return b


def _run_both(arch, opts_kw, steps=3, seq_len=32, batch=4):
    """Both packages from the reference's initial state over `steps`
    steps; returns (port metrics, reference metrics, port state,
    reference state, initial parameters) with the states as numpy
    trees."""
    jcfg = jget_arch(arch).reduced(dtype="float32")
    tcfg = get_arch(arch).reduced(dtype="float32")
    jopts = jtrain.TrainOptions(**opts_kw)
    topts = ttrain.TrainOptions(**opts_kw)
    jstate = jtrain.init_train_state(jcfg, jax.random.PRNGKey(0),
                                     opts=jopts)
    p0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate = train_state_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    jstep = jax.jit(jtrain.make_train_step(jcfg, opts=jopts))
    tstep = ttrain.make_train_step(tcfg, opts=topts)
    dcfg = jpipe.DataConfig(vocab=jcfg.vocab, seq_len=seq_len,
                            global_batch=batch)
    jm, tm = [], []
    for i in range(steps):
        b = _batch(jcfg, dcfg, i)
        jstate, m = jstep(jstate, b)
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, b)
        tm.append({k: float(v) for k, v in m.items()})
    return (tm, jm, train_state_to_numpy(tcfg, tstate),
            jax.tree_util.tree_map(np.asarray, jstate), p0)


@pytest.mark.parametrize("arch,opts_kw", [
    ("minitron-4b", {}),
    ("minitron-4b", {"lr_schedule": "constant"}),
    ("qwen2-vl-2b", {}),
    ("minitron-4b", {"n_micro": 2, "compress_grads": True}),
    ("qwen2-vl-2b", {"n_micro": 2, "compress_grads": True,
                     "lr_schedule": "constant"}),
    # the ssm, hybrid, MoE and encoder-decoder families: K4 and its
    # backward, the shared block with LoRA, the sort dispatch, the encoder
    ("mamba2-370m", {}),
    ("granite-moe-1b-a400m", {}),
    ("granite-moe-1b-a400m", {"n_micro": 2, "compress_grads": True}),
    ("whisper-tiny", {}),
    # deepseek-v3: MLA, the MoE stack and the multi-token-prediction loss
    ("deepseek-v3-671b", {}),
])
def test_train_step_matches_reference(arch, opts_kw):
    _hold_against_reference(arch, opts_kw)


#: zamba2's LoRA A-factors: B starts at zero, so A's gradient is
#: proportional to B.  AdamW's first step moves an element by
#: lr g / (|g| + eps), and one element of each B-factor, whose first
#: gradient lies near eps (1e-8), takes a step that differs by 2-3%
#: between the packages although the gradients agree within 3.3e-5 of
#: their max (test_zamba2_gradients_match_reference_from_the_same_state).
#: A's moments inherit it: 1.3e-3 of their max after step 2, 1.8e-4
#: (in_a) and 6.1e-4 (q_a) after step 3.
LORA_A = {"groups.lora.q_a", "groups.lora.in_a"}
LORA_A_MOMENTS = 2e-3


def test_zamba2_train_step_matches_reference():
    """The hybrid family (SSD layers, the shared block with each group's
    LoRA), as test_train_step_matches_reference holds the other families:
    every bound the same, but the moments of the two LoRA A-factors
    (``LORA_A``), held within ``LORA_A_MOMENTS`` of their max."""
    _hold_against_reference("zamba2-2.7b", {}, loose_moments=LORA_A)


def test_zamba2_gradients_match_reference_from_the_same_state():
    """From the reference's state after one compressed step (n_micro=2,
    compress_grads), each package's gradient on the next batch: every
    leaf within 1e-4 of its max (read: at most 3.3e-5), the LoRA
    A-factors' included, which are no longer 0 once B has moved.  Then
    ``compress_grads`` with that state's error feedback: each reference
    leaf, ``groups.ssm``'s stacked over (G, R) included, has one scale on
    both sides (within 1e-4; read 3.3e-5), and the decompressed gradients
    differ only by one int8 step, where the value before rounding lies
    within 2e-3 of a rounding tie (read: 66 such elements, at most 6.8e-4
    of a step from it), elsewhere within 1e-4 of the leaf's max (read
    3.3e-5).  Three steps of the compressed trajectory
    cannot be held at the file's 1e-2 moment bound: one such flip in the
    last step moves an element of m by 0.1 of a step, which is 1.1e-2 of
    conv_w's max|m|."""
    from repro.optim import compression as jcomp
    from repro_torch import optim as toptim
    from repro_torch.models.convert import (reference_groups,
                                            stack_reference_tree)
    jcfg = jget_arch("zamba2-2.7b").reduced(dtype="float32")
    tcfg = get_arch("zamba2-2.7b").reduced(dtype="float32")
    jopts = jtrain.TrainOptions(n_micro=2, compress_grads=True)
    jstate = jtrain.init_train_state(jcfg, jax.random.PRNGKey(0),
                                     opts=jopts)
    dcfg = jpipe.DataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=4)
    jstate, _ = jax.jit(jtrain.make_train_step(jcfg, opts=jopts))(
        jstate, jpipe.batch_for_step(dcfg, 0))
    b = jpipe.batch_for_step(dcfg, 1)
    jg = jax.jit(jax.grad(lambda p: jlm.loss_fn(jcfg, p, b)))(
        jstate.params)
    jdec, _ = jcomp.compress_grads(jg, jstate.error_fb)
    tstate = train_state_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    model = tstate.params
    tlm.loss_fn(tcfg, model, b).backward()
    grads = [p.grad for p in model.parameters()]
    tdec, _ = toptim.compress_grads(grads, tstate.error_fb,
                                    groups=reference_groups(tcfg, model))
    leaves = zip(_leaves_with_paths(stack_reference_tree(tcfg, model,
                                                         grads)),
                 _leaves_with_paths(jg),
                 _leaves_with_paths(stack_reference_tree(tcfg, model,
                                                         tdec)),
                 _leaves_with_paths(jdec),
                 _leaves_with_paths(jstate.error_fb))
    n_lora_a = 0
    for (path, g, w, t, j, e) in ((p, g.numpy(), np.asarray(w), t.numpy(),
                                   np.asarray(j), np.asarray(e))
                                  for (p, g), (_, w), (_, t), (_, j), (_, e)
                                  in leaves):
        key = ".".join(k.key for k in path)
        assert np.abs(w).max() > 0, key
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key
        n_lora_a += key in LORA_A
        # the largest value before rounding maps to 127 on either side
        s_t, s_j = np.abs(t).max() / 127, np.abs(j).max() / 127
        assert abs(s_t / s_j - 1) < 1e-4, key
        d = np.abs(t - j)
        flip = d > s_j / 2
        assert (d[flip] < 1.5 * s_j).all(), key
        r = (w + e)[flip] / s_j
        assert (np.abs(r - np.floor(r) - 0.5) < 2e-3).all(), key
        assert (d[~flip] <= 1e-4 * np.abs(j).max()).all(), key
    assert n_lora_a == 2


def test_moe_drops_count_once_under_remat():
    """Remat runs an MoE layer's forward again in the backward; the
    dropped assignments are counted once a step, as many as a forward
    without remat counts."""
    import dataclasses
    from repro_torch.models.moe import MoE
    cfg = dataclasses.replace(
        get_arch("granite-moe-1b-a400m").reduced(dtype="float32"),
        capacity_factor=0.5)
    b = tpipe.batch_for_step(tpipe.DataConfig(cfg.vocab, 16, 2), 0)
    dropped = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = tlm.init_params(c, 0, "cpu").requires_grad_(True)
        tlm.loss_fn(c, model, b).backward()
        dropped[remat] = sum(int(m.dropped) for m in model.modules()
                             if isinstance(m, MoE))
    assert dropped[False] > 0
    assert dropped[True] == dropped[False]


def _hold_against_reference(arch, opts_kw, loose_moments=()):
    tm, jm, tstate, jstate, p0 = _run_both(arch, opts_kw)
    for t, j in zip(tm, jm):
        assert t["step"] == j["step"]
        for key in ("loss", "grad_norm", "lr_scale"):
            assert _rel(t[key], j[key]) < RTOL, (key, t[key], j[key])
    atol = 2 * LR * sum(m["lr_scale"] for m in jm)
    _assert_params_close(tstate.params, jstate.params, atol)
    # that bound is as large as what the steps move, so the updates are
    # also held as a whole, and the moments leaf by leaf (with compression
    # an int8 value rounded the other way at a tie moves an element of m
    # by one step, 1/127 of the leaf's max)
    num = den = 0.0
    for (_, a), (_, b), (_, c) in zip(_leaves_with_paths(tstate.params),
                                      _leaves_with_paths(jstate.params),
                                      _leaves_with_paths(p0)):
        num += float(((a - b) ** 2).sum())
        den += float(((b - c) ** 2).sum())
    assert np.sqrt(num / den) < 1e-2
    bound = 1e-2 if opts_kw.get("compress_grads") else 1e-4
    for name in ("m", "v"):
        for (path, a), (_, b) in zip(
                _leaves_with_paths(getattr(tstate.opt, name)),
                _leaves_with_paths(getattr(jstate.opt, name))):
            key = ".".join(k.key for k in path)
            lim = LORA_A_MOMENTS if key in loose_moments else bound
            assert np.abs(a - b).max() <= lim * np.abs(b).max(), \
                (name, path)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3
    if opts_kw.get("compress_grads"):
        assert tstate.error_fb is not None and jstate.error_fb is not None


def test_train_step_raises_for_families_left_to_the_second_half():
    """No family is left: deepseek-v3 with its multi-token-prediction
    block trains (item 11c; the state holds the block, carried across
    both ways), and only a family the port does not know raises."""
    from dataclasses import replace
    cfg = get_arch("deepseek-v3-671b").reduced()
    assert cfg.mtp
    ttrain.make_train_step(cfg)
    state = ttrain.init_train_state(cfg, 0, "cpu")
    assert state.params.mtp is not None
    host = train_state_to_numpy(cfg, state)
    assert set(host.params["mtp"]) == {"proj", "layer", "norm"}
    back = train_state_from_numpy(cfg, host, "cpu")
    for a, b in zip(state.params.parameters(), back.params.parameters()):
        assert torch.equal(a, b)
    odd = replace(cfg, family="diffusion")
    with pytest.raises(NotImplementedError, match="diffusion"):
        ttrain.make_train_step(odd)
    with pytest.raises(NotImplementedError, match="diffusion"):
        ttrain.init_train_state(odd, 0, "cpu")


def test_whisper_encoder_gets_the_reference_gradients():
    """Training whisper reaches its encoder: every encoder parameter
    (enc_pos, enc_norm, enc_layers) gets a gradient, nonzero, equal to
    jax.grad of the reference's loss_fn on the same weights and batch
    within 1e-4 of each leaf's max."""
    from repro_torch.models.convert import (params_from_numpy,
                                            stack_reference_tree)
    jcfg = jget_arch("whisper-tiny").reduced(dtype="float32")
    tcfg = get_arch("whisper-tiny").reduced(dtype="float32")
    params = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    b = _batch(jcfg, jpipe.DataConfig(jcfg.vocab, 16, 2), 0)
    want = jax.grad(lambda p: jlm.loss_fn(jcfg, p, b))(params)
    model = params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    model.requires_grad_(True)
    tlm.loss_fn(tcfg, model, b).backward()
    got = stack_reference_tree(tcfg, model,
                               [p.grad for p in model.parameters()])
    n = 0
    for key in ("enc_pos", "enc_norm", "enc_layers"):
        for (path, g), (_, w) in zip(_leaves_with_paths(got[key]),
                                     _leaves_with_paths(want[key])):
            w = np.asarray(w)
            assert np.abs(w).max() > 0, (key, path)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{key} {path}")
            n += 1
    assert n == 2 + len(_leaves_with_paths(want["enc_layers"]))


def test_train_loop_refuses_an_encoder_decoder_config():
    """The reference's train_loop feeds tokens and labels only; the
    port's says why it cannot train whisper."""
    with pytest.raises(ValueError, match="audio_embed"):
        train_loop("whisper-tiny", steps=1, device="cpu")


def test_loss_fn_matches_reference_both_ways():
    """loss_fn through fused_ce and through cross_entropy of the logits,
    on the same weights, against the reference's."""
    import dataclasses
    for fused in (True, False):
        jcfg = dataclasses.replace(
            jget_arch("minitron-4b").reduced(dtype="float32"),
            fused_ce_loss=fused, ce_chunk=8)
        tcfg = dataclasses.replace(
            get_arch("minitron-4b").reduced(dtype="float32"),
            fused_ce_loss=fused, ce_chunk=8)
        params = jlm.init_params(jcfg, jax.random.PRNGKey(1))
        from repro_torch.models.convert import params_from_numpy
        model = params_from_numpy(
            tcfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
        b = jpipe.batch_for_step(jpipe.DataConfig(jcfg.vocab, 21, 2), 0)
        want = float(jlm.loss_fn(jcfg, params, b))
        got = float(tlm.loss_fn(tcfg, model, b))
        assert _rel(got, want) < 1e-5, (fused, got, want)


def test_remat_recomputes_the_layers_and_gives_the_same_grads():
    """With cfg.remat the backward runs each layer's forward again (K2's
    forward on the card: the attention count doubles) and the gradients
    are those without it."""
    import dataclasses
    cfg = get_arch("minitron-4b").reduced(dtype="float32")
    b = tpipe.batch_for_step(tpipe.DataConfig(cfg.vocab, 16, 2), 0)
    grads = {}
    calls = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = tlm.init_params(c, 0, "cpu").requires_grad_(True)
        n = [0]
        orig = tlm._decoder_layer

        def counting(*a, **kw):
            n[0] += 1
            return orig(*a, **kw)
        tlm._decoder_layer = counting
        try:
            loss = tlm.loss_fn(c, model, b)
            grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
        finally:
            tlm._decoder_layer = orig
        calls[remat] = n[0]
    assert calls == {False: cfg.n_layers, True: 2 * cfg.n_layers}
    for a, g in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, g, atol=1e-6, rtol=1e-5)


def test_batch_for_step_equals_reference():
    for cfg_kw in ({"vocab": 512, "seq_len": 32, "global_batch": 4},
                   {"vocab": 256000, "seq_len": 128, "global_batch": 8,
                    "seed": 3, "n_hosts": 2, "host_id": 1}):
        for step in (0, 7):
            want = jpipe.batch_for_step(jpipe.DataConfig(**cfg_kw), step)
            got = tpipe.batch_for_step(tpipe.DataConfig(**cfg_kw), step)
            assert want.keys() == got.keys()
            for k in want:
                assert np.array_equal(got[k], want[k])
    p = tpipe.Pipeline(tpipe.DataConfig(512, 16, 2), start_step=5)
    try:
        assert np.array_equal(next(p)["tokens"], tpipe.batch_for_step(
            tpipe.DataConfig(512, 16, 2), 5)["tokens"])
    finally:
        p.close()


def test_train_loop_restart_resumes_the_uninterrupted_run():
    """As tests/test_train_e2e.py's restart test, on the port and
    reduced minitron-4b: 8 steps checkpointed every 4, then on to 12 from
    the checkpoint, against 12 uninterrupted."""
    d = tempfile.mkdtemp()
    try:
        kw = dict(seq_len=32, global_batch=4, log_every=100, device="cpu")
        train_loop("minitron-4b", steps=8, ckpt_dir=d, ckpt_every=4, **kw)
        b = train_loop("minitron-4b", steps=12, ckpt_dir=d, ckpt_every=4,
                       **kw)
        c = train_loop("minitron-4b", steps=12, **kw)
        assert len(b) == 4
        np.testing.assert_allclose(b, c[-4:], atol=1e-4)
        assert sorted(os.listdir(d)) == ["step_00000004", "step_00000008",
                                         "step_00000012"]
    finally:
        shutil.rmtree(d)


def test_train_loop_loss_decreases():
    """As tests/test_train_e2e.py's loss test, on the port."""
    losses = train_loop("qwen2-vl-2b", steps=25, seq_len=64,
                        global_batch=8, log_every=100, device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_loop_refuses_a_mesh_and_needs_a_device(monkeypatch):
    """A mesh of more than one rank needs a process group of its size
    (``tests/test_torch_dist.py`` trains on one); without a GPU and
    without an explicit device the loop raises."""
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        train_loop("minitron-4b", steps=1, n_data=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop("minitron-4b", steps=1)


# --------------------------------------------------------------------------
# the losses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk_s", [(13, 4), (16, 16), (9, 512)])
def test_fused_ce_matches_reference(S, chunk_s):
    """Value and gradients of fused_ce against the reference's custom VJP,
    with -1 labels and S not a multiple of chunk_s, within 1e-5 of each
    quantity's scale."""
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(S)
    h = rng.normal(size=(2, S, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 40)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, S)).astype(np.int32)
    labels[0, 1] = labels[1, -1] = -1
    want, (gh, gw) = jax.value_and_grad(
        lambda h_, w_: jlayers.fused_ce(h_, w_, jnp.asarray(labels),
                                        chunk_s), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tlayers.fused_ce(th, tw, torch.from_numpy(labels), chunk_s)
    got.backward()
    assert _rel(got.detach(), want) < 1e-5
    for g, r in ((th.grad, gh), (tw.grad, gw)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())
    # and against cross_entropy of the full logits (no -1 there)
    lab = np.maximum(labels, 0)
    full = tlayers.cross_entropy(torch.from_numpy(h) @ torch.from_numpy(w),
                                 torch.from_numpy(lab))
    ref = jlayers.cross_entropy(jnp.asarray(h) @ jnp.asarray(w),
                                jnp.asarray(lab))
    assert _rel(full, ref) < 1e-5
    assert _rel(tlayers.fused_ce(torch.from_numpy(h), torch.from_numpy(w),
                                 torch.from_numpy(lab), chunk_s), ref) < 1e-5
