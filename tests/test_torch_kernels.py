"""The port's kernels on the CPU (their plain PyTorch versions) against
the JAX package's Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them.  Inputs come from numpy with a fixed
seed.  Tolerance atol 2e-3 / rtol 1e-3 in float32: both sides stream the
softmax in f32 but sum in different orders and block sizes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import flash_attention_bwd as t_fab
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import neutron_matmul as t_k1
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as t_ssd
from repro_torch.kernels import ref as tref

ATOL, RTOL = 2e-3, 1e-3


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# --------------------------------------------------------------------------
# flash attention (K2)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,causal,window", [
    (1, 1, 1, 16, 8, 8, True, None),
    (2, 4, 2, 100, 32, 32, True, None),        # GQA, ragged S
    (2, 4, 2, 100, 32, 32, False, None),
    (1, 4, 2, 77, 16, 16, True, 7),            # sliding window
    (1, 2, 2, 90, 16, 16, True, 64),
    (2, 4, 4, 48, 24, 16, True, None),         # Dv != D
    (1, 6, 3, 40, 16, 8, False, None),         # GQA, Dv != D
])
def test_flash_attention_matches_pallas(B, H, Hkv, S, D, Dv, causal,
                                        window):
    rng = np.random.default_rng(S * 7 + D)
    q, k, v = (_normal(rng, B, H, S, D), _normal(rng, B, Hkv, S, D),
               _normal(rng, B, Hkv, S, Dv))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window, impl="pallas", block_q=32,
                                block_k=32)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window)
    assert got.shape == (B, H, S, Dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_flash_attention_ref_block_size_invariant():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 2, 70, 16))
               for _ in range(3))
    a = tref.flash_attention_ref(q, k, v, block_k=512)
    b = tref.flash_attention_ref(q, k, v, block_k=16)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# flash decode (K3)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,kv_len,return_lse", [
    (3, 4, 2, 50, 32, 32, (1, 17, 50), True),   # GQA, kv_len per lane
    (3, 4, 2, 50, 32, 32, (1, 17, 50), False),
    (2, 4, 4, 300, 16, 16, (1, 300), True),     # crosses a Pallas block
    (2, 4, 2, 64, 24, 16, (40, 9), True),       # Dv != D
    (2, 6, 2, 33, 8, 8, None, False),           # kv_len omitted
])
def test_flash_decode_matches_pallas(B, H, Hkv, S, D, Dv, kv_len,
                                     return_lse):
    # kv_len >= 1 throughout: at 0 the kernel gives 0 and the plain
    # version the mean of v.
    rng = np.random.default_rng(S + D)
    q, k, v = (_normal(rng, B, H, D), _normal(rng, B, Hkv, S, D),
               _normal(rng, B, Hkv, S, Dv))
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kv_len=None if lens is None
                             else jnp.asarray(lens),
                             return_lse=return_lse, impl="pallas")
    got = tops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            kv_len=None if lens is None
                            else torch.from_numpy(lens),
                            return_lse=return_lse)
    if return_lse:
        (got, got_lse), (want, want_lse) = got, want
        assert got_lse.shape == (B, H) and got_lse.dtype == torch.float32
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   atol=ATOL, rtol=RTOL)
    assert got.shape == (B, H, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_flash_decode_ref_matches_jax_ref_bf16():
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, 2, 4, 32), _normal(rng, 2, 4, 40, 32),
               _normal(rng, 2, 4, 40, 32))
    lens = np.asarray([7, 40], np.int32)
    want = jref.flash_decode_ref(jnp.asarray(q, jnp.bfloat16),
                                 jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16),
                                 kv_len=jnp.asarray(lens))
    got = tref.flash_decode_ref(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        kv_len=torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


# --------------------------------------------------------------------------
# activations and dispatch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["none", "relu", "relu6", "silu", "gelu",
                                 "sigmoid", "sqrelu", "mish"])
def test_apply_activation_matches_jax(act):
    x = _normal(np.random.default_rng(1), 64, 33) * 4
    want = jref.apply_activation(jnp.asarray(x), act)
    got = tref.apply_activation(torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_activation_names_match_jax():
    assert tref.ACTIVATIONS == jref.ACTIVATIONS
    with pytest.raises(ValueError):
        tref.apply_activation(torch.zeros(2), "swish")


@pytest.mark.parametrize("wrapper,args,kw", [
    (t_fa.flash_attention, ((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)),
     {}),
    (t_fd.flash_decode, ((1, 2, 16), (1, 2, 8, 16), (1, 2, 8, 16)), {}),
    (t_ssd.ssd_chunk, ((1, 32, 3, 16), (1, 32, 3), (3,), (1, 32, 8),
                       (1, 32, 8)), dict(chunk=16)),
])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper, args, kw):
    """A kernel wrapper launches its kernel or raises: it never computes
    the plain version itself, and counts no launch when it raises."""
    before = (t_fa.launches, t_fd.launches, t_ssd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*(torch.zeros(s) for s in args), **kw)
    assert (t_fa.launches, t_fd.launches, t_ssd.launches) == before


@pytest.mark.parametrize("wrapper,shapes,kw,match", [
    (t_fa.flash_attention, ((1, 2, 8, 16), (2, 8, 16), (1, 2, 8, 16)), {},
     r"k, v must be \(B,Hkv,Sk,D\)"),
    (t_fa.flash_attention, ((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)),
     {}, "do not match"),
    (t_fa.flash_attention, ((1, 3, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)),
     {}, "H=3 is not a multiple of Hkv=2"),
    (t_fa.flash_attention, ((1, 2, 0, 16), (1, 2, 8, 16), (1, 2, 8, 16)),
     {}, "nonempty B, H, S, Sk"),
    (t_fa.flash_attention, ((1, 2, 8, 12), (1, 2, 8, 12), (1, 2, 8, 12)),
     {}, "multiples of 8 up to 256"),
    (t_fa.flash_attention, ((1, 2, 8, 264), (1, 2, 8, 264),
                            (1, 2, 8, 264)), {}, "multiples of 8 up to 256"),
    (t_fa.flash_attention, ((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)),
     dict(window=0), "window must be >= 1"),
    (t_fd.flash_decode, ((1, 2, 16), (2, 8, 16), (1, 2, 8, 16)), {},
     r"k, v must be \(B,Hkv,S,D\)"),
    (t_fd.flash_decode, ((1, 2, 16), (1, 2, 8, 16), (1, 2, 9, 16)), {},
     "do not match"),
    (t_fd.flash_decode, ((1, 3, 16), (1, 2, 8, 16), (1, 2, 8, 16)), {},
     "H=3 is not a multiple of Hkv=2"),
    (t_fd.flash_decode, ((1, 2, 300), (1, 2, 8, 300), (1, 2, 8, 300)), {},
     "flash_decode takes 1 <= D, Dv <= 256"),
    (t_fd.flash_decode, ((1, 2, 16), (1, 2, 0, 16), (1, 2, 0, 16)), {},
     "nonempty B, H, S"),
])
def test_kernel_wrappers_refuse_bad_shapes(wrapper, shapes, kw, match):
    """Shapes the kernels do not take are refused, with the reason, before
    the device is looked at; no launch is counted."""
    before = (t_fa.launches, t_fd.launches)
    with pytest.raises(ValueError, match=match):
        wrapper(*(torch.zeros(s) for s in shapes), **kw)
    assert (t_fa.launches, t_fd.launches) == before


@pytest.mark.parametrize("S", [1, 63, 64, 65, 116, 216, 1000, 8192])
@pytest.mark.parametrize("Hkv", [1, 8, 32])
@pytest.mark.parametrize("B", [1, 4, 16])
def test_flash_decode_split_plan(B, Hkv, S):
    """K3's key ranges cover every key once, keep at least 64 keys each
    when there are several, and fill the H100's 132 SMs with B * Hkv *
    splits blocks wherever S allows it (else take as many as it does)."""
    splits = t_fd.num_splits(B, Hkv, S)
    assert splits >= 1
    bounds = t_fd.split_bounds(S, splits)
    assert len(bounds) == splits
    assert [k for lo, hi in bounds for k in range(lo, hi)] == list(range(S))
    if splits > 1:
        assert min(hi - lo for lo, hi in bounds) >= 64
    need = -(-132 // (B * Hkv))
    if S // 64 >= need:
        assert B * Hkv * splits >= 132
    else:
        assert splits == max(1, S // 64)


def test_ops_reject_unknown_impl():
    q = torch.zeros(1, 2, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="impl"):
        tops.flash_decode(q, k, k, impl="pallas")


# --------------------------------------------------------------------------
# the kernels' launch plans (pure functions, so they are tested here)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("K", [24, 320, 1280, 2048, 2304, 4608])
@pytest.mark.parametrize("tiles", [1, 7, 16, 56, 131, 132, 1568])
def test_neutron_matmul_split_plan(tiles, K):
    """K1's k-split: none where the tiles fill the 132 SMs; else enough
    that tiles * splits blocks fill them, as far as every split keeps at
    least two k-tiles of 64 bytes; the splits' k-tile ranges (balanced, as
    the kernel computes them) cover every k-tile once."""
    splits = t_k1.num_splits(tiles, K)
    k_tiles = -(-K // 64)
    assert splits >= 1
    if tiles >= 132:
        assert splits == 1
    elif k_tiles // 2 >= -(-132 // tiles):
        assert tiles * splits >= 132
    else:
        assert splits == max(1, k_tiles // 2)
    bounds = [(s * k_tiles // splits, (s + 1) * k_tiles // splits)
              for s in range(splits)]
    assert [k for lo, hi in bounds for k in range(lo, hi)] == \
        list(range(k_tiles))
    if splits > 1:
        assert min(hi - lo for lo, hi in bounds) >= 2


@pytest.mark.parametrize("K,strides,ptrs,width", [
    (1280, (1344, 0, 1280), (0, 512), 16),
    (24, (56 * 56 * 24, 2 * 56 * 24, 48), (64, 512), 8),   # C = 24, stride 2
    (24, (56 * 56 * 24, 56 * 24, 24), (64, 512), 8),
    (20, (1812, 360, 40), (64, 512), 4),
    (27, (12544 * 27, 0, 27), (0, 512), 1),
    (576, (3136 * 576, 0, 576), (8, 512), 8),                # base 8 aligned
    (576, (3136 * 576, 0, 576), (0, 4), 4),
    (4608, (49 * 4608, 0, 4608), (2, 0), 1),
])
def test_neutron_matmul_load_width(K, strides, ptrs, width):
    """K1's copies are as wide as K, every stride and both base addresses
    allow: 16, 8 or 4 bytes, else byte loads."""
    assert t_k1.load_width(K, strides, ptrs) == width


@pytest.mark.parametrize("shape,plan", [
    # (batch, M, N, K, x_bstride, x_ow, x_sy, x_sx) -> (load, splits)
    ((8, 12544, 32, 27, 12544 * 27, 12544, 0, 27), (t_k1.SPAN, 1)),
    ((8, 12544, 64, 147, 12544 * 147, 12544, 0, 147), (t_k1.SPAN, 1)),
    ((8, 3136, 64, 576, 3136 * 576, 3136, 0, 576), (16, 1)),
    ((8, 49, 1280, 320, 49 * 320, 49, 0, 320), (16, 1)),
    ((8, 1, 1000, 1280, 1344, 1, 0, 1280), (16, 9)),          # the fc
    ((8, 1, 1000, 2048, 2112, 1, 0, 2048), (16, 9)),
    ((8, 49, 512, 4608, 49 * 4608, 49, 0, 4608), (16, 3)),
    ((8, 196, 32, 24, 112 * 112 * 24, 14, 2 * 112 * 24, 48), (8, 1)),
    ((2, 200, 64, 147, 200 * 147 + 64, 200, 0, 147), (1, 1)),  # gapped
    ((1, 100, 70, 300, 30000, 100, 0, 300), (4, 2)),
])
def test_neutron_matmul_plan_at_path_shapes(shape, plan):
    """The stems' contiguous im2col rows take span mode; a batch stride
    that breaks the span falls back to the ring at the width it allows;
    the fc and the M = 49 convs of K >= 2304 split along K."""
    pl = t_k1.plan(*shape, 0, 512)
    assert (pl.load, pl.splits) == plan
    B, M, N = shape[:3]
    assert pl.row_tiles == -(-B * M // 64) and pl.col_tiles == -(-N // 64)


@pytest.mark.parametrize("args,contiguous", [
    ((8, 12544, 27, 12544 * 27, 12544, 0, 27), True),
    ((1, 12544, 27, 999, 12544, 0, 27), True),          # one image
    ((8, 12544, 27, 12544 * 27 + 64, 12544, 0, 27), False),
    ((8, 196, 24, 196 * 24, 14, 14 * 24, 24), True),     # (R, C, K) dense
    ((8, 196, 24, 196 * 24, 14, 28 * 24, 24), False),    # every 2nd row
    ((8, 196, 24, 196 * 24, 14, 14 * 48, 48), False),    # stride 2
])
def test_neutron_matmul_rows_contiguous(args, contiguous):
    assert t_k1.rows_contiguous(*args) == contiguous


@pytest.mark.parametrize("contract,dtype,key", [
    (t_k1._PLAN, torch.int8, "plan int8"),
    (t_k1._PALLAS, torch.int8, "pallas int8"),
    (t_k1._PALLAS, torch.float32, "pallas float32"),
    (t_k1._PALLAS, torch.bfloat16, "pallas bfloat16"),
])
def test_neutron_matmul_contract_key(contract, dtype, key):
    """What K1's ``launches_by_contract`` counts a launch under."""
    assert t_k1.contract_key(contract, dtype) == key


# K1's float32 GEMMs of chip_smoke.py phase 2 at contiguous x: the float32
# mobilenet_v2 plan's stem, last 1x1 and fc at batch 8, the whisper-tiny
# decoder's logits (a step, a prefill of 64), ff out and ff in
@pytest.mark.parametrize("shape,want", [
    # (batch, M, N, K) -> (route, tile_n, load, splits)
    ((8, 12544, 32, 27), (t_k1.TILED, 32, 4, 1)),      # stem: K 27, 4 B
    ((8, 49, 1280, 320), (t_k1.TILED, 64, 16, 1)),     # 140 tiles
    ((8, 1, 1000, 1280), (t_k1.SKINNY, 4, 16, 4)),     # fc: 8 rows
    ((1, 1, 51865, 384), (t_k1.SKINNY, 16, 16, 1)),    # logits step
    ((1, 64, 51865, 384), (t_k1.TILED, 64, 16, 1)),    # prefill logits
    ((1, 1, 384, 1536), (t_k1.SKINNY, 4, 16, 4)),      # ff out
    ((1, 1, 1536, 384), (t_k1.SKINNY, 16, 16, 1)),     # ff in
    ((1, 64, 384, 1536), (t_k1.TILED, 64, 16, 22)),    # prefill ff out
])
def test_neutron_matmul_float_plan_at_path_shapes(shape, want):
    """The float plan at the path's GEMMs: the fc and a decode step's
    products on the skinny route (K split over 4 warps where N is small),
    the rest tiled; the stem's 32 columns in a 32-wide tile; 4-byte copies
    where K = 27 breaks 16-byte alignment; K split over blocks only where
    the tiles leave SMs idle."""
    B, M, N, K = shape
    assert tuple(t_k1.float_plan(B, M, N, K, (M * K, 0, K), (0, 512))) == \
        want


@pytest.mark.parametrize("R", [1, 15, 16, 17, 63, 64])
@pytest.mark.parametrize("N,K", [(40, 64), (1000, 1280), (51865, 384),
                                 (384, 1536), (1, 27), (129, 1001)])
def test_neutron_matmul_float_plan_invariants(R, N, K):
    """At any R, N, K: the route is SKINNY exactly up to 16 rows; a
    skinny block's columns are 2 a warp over 8 / splits warp pairs, each
    splitting warp keeps at least 256 elements of K where there is more
    than one; a tiled split keeps at least one k-tile (two where K is
    split); the plan does not depend on the pointer values but through
    the load width."""
    for B, M in ((1, R), (R, 1)):
        a = t_k1.float_plan(B, M, N, K, (M * K, 0, K), (0, 512))
        b = t_k1.float_plan(B, M, N, K, (M * K, 0, K), (4, 516))
        assert (a.route, a.tile_n, a.splits) == (b.route, b.tile_n, b.splits)
        assert b.load == 4 and a.load == (16 if K % 4 == 0 else 4)
        if R <= t_k1.SKINNY_MAX_ROWS:
            assert a.route == t_k1.SKINNY and a.splits in (1, 2, 4, 8)
            assert a.tile_n == 2 * 8 // a.splits
            if a.splits > 1:
                assert K // a.splits >= t_k1.SKINNY_MIN_K
        else:
            k_tiles = -(-K // t_k1.F_BK)
            assert a.route == t_k1.TILED
            assert a.tile_n == (32 if N <= 32 else 64)
            assert 1 <= a.splits <= k_tiles
            if a.splits > 1:
                assert k_tiles // a.splits >= t_k1.MIN_SPLIT_KTILES
                assert -(-R // 64) * -(-N // a.tile_n) < t_k1.SMS


def test_neutron_matmul_float_plan_strided_view():
    """A stride-2 1x1 conv's view over C = 96 channels (rows 768 bytes
    apart, images apart by a slot's pitch) keeps 16-byte loads; over C =
    27 channels it falls to one element a load; bf16 counts in 2-byte
    elements."""
    strided = (28 * 28 * 96, 2 * 28 * 96, 2 * 96)
    assert t_k1.float_plan(8, 196, 160, 96, strided, (0, 512)) == \
        t_k1.FloatPlan(t_k1.TILED, 64, 16, 1)
    assert t_k1.float_plan(8, 196, 160, 27, (28 * 28 * 27, 2 * 28 * 27,
                                             54), (0, 512)).load == 4
    assert t_k1.float_plan(1, 8, 40, 64, (512, 0, 64), (0, 512), 2) == \
        t_k1.FloatPlan(t_k1.SKINNY, 16, 16, 1)
    assert t_k1.float_plan(1, 8, 40, 60, (480, 0, 60), (0, 512), 2).load \
        == 2


def test_neutron_matmul_split_scratch_kept_per_stream_and_dtype(
        monkeypatch):
    """A split's partials and tickets are kept per (device, stream, dtype
    of the partials): the int8 body's int32 sums and the float body's
    float32 tiles of one stream are apart, grown when a call needs more
    and reused, zeroed, when it needs no more."""
    monkeypatch.setattr(t_k1, "_scratch", {})
    dev = torch.device("cpu")
    p8, t8 = t_k1._scratch_for(dev, 7, 4, 4 * t_k1.TILE ** 2, torch.int32)
    pf, tf = t_k1._scratch_for(dev, 7, 6, 6 * 3 * 64 * 32, torch.float32)
    assert (p8.dtype, p8.numel(), t8.numel()) == \
        (torch.int32, 4 * t_k1.TILE ** 2, 4)
    assert (pf.dtype, pf.numel(), tf.numel()) == \
        (torch.float32, 6 * 3 * 64 * 32, 6)
    assert tf.data_ptr() != t8.data_ptr()
    assert not (p8.any() or t8.any() or pf.any() or tf.any())
    again = t_k1._scratch_for(dev, 7, 2, 100, torch.float32)
    assert again[0] is pf and again[1] is tf
    grown = t_k1._scratch_for(dev, 7, 9, 9 * 64 * 64, torch.float32)
    assert grown[0].numel() == 9 * 64 * 64 and grown[1].numel() == 9
    assert t_k1._scratch_for(dev, 8, 1, 1, torch.float32)[0] is not \
        grown[0]


# K2b's shapes of chip_smoke.py phase 2 (B, H, Hkv, S, D, Dv, dtype) and
# the route and G each takes
@pytest.mark.parametrize("shape,want", [
    ((8, 32, 32, 128, 128, 128, torch.bfloat16), (t_fab.MMA, 1)),
    ((4, 48, 1, 100, 128, 128, torch.bfloat16), (t_fab.MMA, 24)),
    ((1, 32, 16, 1040, 128, 128, torch.bfloat16), (t_fab.MMA, 1)),
    ((2, 16, 16, 100, 192, 128, torch.bfloat16), (t_fab.MMA, 1)),
    ((2, 6, 2, 77, 32, 24, torch.float32), (t_fab.SCALAR, 1)),
    ((2, 6, 2, 77, 32, 24, torch.bfloat16), (t_fab.SCALAR, 1)),   # Dv 24
    ((1, 2, 1, 40, 256, 256, torch.bfloat16), (t_fab.SCALAR, 1)),  # D 256
    ((2, 4, 2, 65, 80, 80, torch.bfloat16), (t_fab.MMA, 2)),   # 8 blocks
    ((1, 48, 1, 70, 128, 128, torch.bfloat16), (t_fab.MMA, 48)),
])
def test_flash_attention_bwd_plan_at_path_shapes(shape, want):
    """K2b's route: MMA for bf16 with D and Dv multiples of 16 up to 192,
    else SCALAR; a group of 48 over 8 blocks splits into 24 slices of 2
    heads (192 blocks), over 2 blocks into 48."""
    B, H, Hkv, S, D, Dv, dtype = shape
    assert tuple(t_fab.bwd_plan(dtype, B, Hkv, S, H // Hkv, D, Dv)) == want


@pytest.mark.parametrize("B,Hkv,Sk", [(1, 1, 1), (4, 1, 100), (8, 32, 128),
                                      (1, 16, 1040), (2, 2, 77),
                                      (1, 3, 64)])
@pytest.mark.parametrize("group", [1, 2, 6, 7, 48])
def test_flash_attention_bwd_group_split(B, Hkv, Sk, group):
    """G divides the group (every slice has group / G heads); 1 where the
    key-tile grid fills the 132 SMs; else the smallest divisor that fills
    them, or the whole group where none does."""
    G = t_fab.group_split(B, Hkv, Sk, group)
    blocks = B * Hkv * -(-Sk // 64)
    assert group % G == 0
    if blocks >= 132 or group == 1:
        assert G == 1
    elif blocks * group < 132:
        assert G == group
    else:
        assert blocks * G >= 132
        assert all(blocks * d < 132 for d in range(1, G) if group % d == 0)


@pytest.mark.parametrize("pairs,H,group", [
    (8, 80, 3),      # zamba2-2.7b prefill: 216 blocks
    (8, 32, 1),      # mamba2-370m: 256 blocks
    (2, 3, 1), (8, 5, 1), (64, 80, 8), (33, 8, 1), (66, 8, 3), (198, 4, 4),
    (1, 1, 1),
])
def test_ssd_chunk_head_group(pairs, H, group):
    """K4's bf16 blocks take the largest group of heads (up to 8) whose
    grid still makes 1.5 waves of the 132 SMs, else one head."""
    assert t_ssd.head_group(pairs, H) == group
    if group > 1:
        assert pairs * -(-H // group) >= 198
        if group < min(8, H):
            assert pairs * -(-H // (group + 1)) < 198


@pytest.mark.parametrize("pairs,H,group", [
    (8, 32, 1),      # mamba2-370m: training (8 x 128) and serving (4 x 256)
    (8, 80, 3),      # zamba2-2.7b: training and serving, 216 blocks
    (100, 3, 2), (66, 5, 2), (100, 5, 4),   # groups not dividing H
    (2, 3, 1), (1, 1, 1), (33, 8, 1), (200, 80, 8), (198, 4, 4),
])
def test_ssd_bwd_head_group(pairs, H, group):
    """K4b's bf16 blocks (one an SM) take the largest group of heads, up
    to MAX_GROUP, whose grid still makes 1.5 waves of the 132 SMs, else
    one head."""
    from repro_torch.kernels import ssd_scan_bwd as t_ssdb
    got = t_ssdb.bwd_head_group(pairs, H)
    assert got == group
    assert 1 <= got <= min(t_ssd.MAX_GROUP, H)
    if got > 1:
        assert pairs * -(-H // got) >= 1.5 * 132
    if got < min(t_ssd.MAX_GROUP, H):
        assert pairs * -(-H // (got + 1)) < 1.5 * 132


@pytest.mark.parametrize("call,match", [
    (lambda: t_k1.neutron_matmul(torch.zeros(4, 8), torch.zeros(8, 3)),
     "CUDA"),
    (lambda: t_k1.neutron_matmul(torch.zeros(4, 8), torch.zeros(9, 3)),
     "do not match"),
    (lambda: t_k1.neutron_matmul_plan(
        torch.zeros(2, 3, 8, dtype=torch.int8),
        torch.zeros(5, 8, dtype=torch.int8), None, torch.ones(5),
        "relu", 0.1, 0, -128, 127,
        torch.zeros(2, 3, 5, dtype=torch.int8)), "CUDA"),
    (lambda: t_k1.neutron_matmul_plan(
        torch.zeros(2, 3, 8, dtype=torch.int8),
        torch.zeros(5, 7, dtype=torch.int8), None, torch.ones(5),
        "relu", 0.1, 0, -128, 127,
        torch.zeros(2, 3, 5, dtype=torch.int8)), r"w must be contiguous"),
    (lambda: t_k1.neutron_matmul_plan(
        torch.zeros(2, 3, 8, dtype=torch.int8),
        torch.zeros(5, 8, dtype=torch.int8), None, torch.ones(5),
        "relu", 0.1, 0, -128, 127,
        torch.zeros(2, 4, 5, dtype=torch.int8)), r"out must be \(2, 3, 5\)"),
    (lambda: t_ssd.ssd_chunk(torch.zeros(1, 40, 3, 16),
                             torch.zeros(1, 40, 3), torch.zeros(3),
                             torch.zeros(1, 40, 8), torch.zeros(1, 40, 8),
                             16), "S=40 is not a multiple of chunk=16"),
    (lambda: t_ssd.ssd_chunk(torch.zeros(1, 32, 3, 16),
                             torch.zeros(1, 32, 3), torch.zeros(3),
                             torch.zeros(1, 32, 200), torch.zeros(1, 32, 200),
                             16), "N, P <= 128"),
])
def test_k1_k4_wrappers_refuse(call, match):
    """K1's and K4's wrappers refuse what their kernels do not take, with
    the reason, on the CPU, before any launch; no launch is counted."""
    before = (t_k1.launches, t_ssd.launches)
    with pytest.raises(ValueError, match=match):
        call()
    assert (t_k1.launches, t_ssd.launches) == before


# --------------------------------------------------------------------------
# flash attention's backward (FlashAttentionFn on the CPU: the plain
# versions of K2 with its LSE and of K2b)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,causal,window,block_k", [
    (2, 4, 4, 40, 16, 16, True, None, 16),     # S not a multiple of block_k
    (1, 4, 2, 37, 16, 16, True, None, 512),    # GQA
    (2, 4, 2, 50, 16, 8, True, 7, 16),         # window, Dv != D
    (1, 2, 2, 33, 24, 24, False, None, 8),     # not causal
    (1, 6, 3, 20, 32, 16, False, 5, 512),      # window not causal
])
def test_flash_attention_fn_grads_match_reference_vjp(B, H, Hkv, S, D, Dv,
                                                      causal, window,
                                                      block_k):
    """``ops.flash_attention`` under grad (``FlashAttentionFn``): output
    and the gradients of q, k and v against ``jax.vjp`` of the reference's
    ``ops.flash_attention(impl="ref", fused_vjp=True)``, which repeats
    grouped kv heads, as the port does before its Function."""
    import jax
    rng = np.random.default_rng(B * 100 + S + D)
    q, k, v = (_normal(rng, B, H, S, D), _normal(rng, B, Hkv, S, D),
               _normal(rng, B, Hkv, S, Dv))
    do = _normal(rng, B, H, S, Dv)
    o_j, vjp = jax.vjp(
        lambda q_, k_, v_: jops.flash_attention(
            q_, k_, v_, causal=causal, window=window, impl="ref",
            fused_vjp=True, block_k=block_k),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o = tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                             block_k=block_k)
    assert o.grad_fn is not None
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j),
                               atol=ATOL, rtol=RTOL)
    for got, w in zip((tq, tk, tv), want):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 9),
                                           (False, None)])
def test_flash_attention_fwd_lse_matches_reference(causal, window):
    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, 2, 3, 45, 16), _normal(rng, 2, 3, 45, 16),
               _normal(rng, 2, 3, 45, 8))
    o_j, lse_j = jref._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, window,
                                     0.25, 16)
    o, lse = tref.flash_attention_fwd_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, sm_scale=0.25, block_k=16)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, 45)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL,
                               rtol=RTOL)


def test_flash_attention_bwd_ref_matches_reference():
    """The plain backward from the same residuals as ``_faf_bwd``."""
    rng = np.random.default_rng(12)
    q, k, v = (_normal(rng, 1, 2, 30, 16), _normal(rng, 1, 2, 30, 16),
               _normal(rng, 1, 2, 30, 24))
    do = _normal(rng, 1, 2, 30, 24)
    o, lse = jref._flash_fwd_lse(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), True, 11, 0.3, 8)
    want = jref._faf_bwd(True, 11, 0.3, 8, (jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), o, lse),
                         jnp.asarray(do))
    got = tref.flash_attention_bwd_ref(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)),
        causal=True, window=11, sm_scale=0.3, block_k=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("call", [
    lambda x: tops.neutron_matmul(x, torch.zeros(8, 3)),
    lambda x: tops.neutron_matmul_nk(x[None], torch.zeros(3, 8), None,
                                     "none", torch.zeros(1, 4, 3)),
    lambda x: tops.flash_decode(x.reshape(1, 4, 8), torch.zeros(1, 4, 5, 8),
                                torch.zeros(1, 4, 5, 8)),
    lambda x: tops.flash_attention(
        x.reshape(1, 1, 4, 8), torch.zeros(1, 1, 4, 8),
        torch.zeros(1, 1, 4, 8), q_offset=torch.zeros(1, dtype=torch.int32)),
])
def test_kernels_without_backward_refuse_a_grad(call):
    """A tensor that requires grad reaching K1, K3 or K2 with a query
    offset under grad mode raises, on the CPU as on the card; under
    no_grad, or with impl="ref", the same call runs."""
    x = torch.zeros(4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        call(x)
    with torch.no_grad():
        call(x)
    call(x.detach())


@pytest.mark.parametrize("S,chunk,init", [(13, 4, True), (16, 16, False)])
def test_ssd_scan_under_grad_gives_the_plain_versions_gradients(S, chunk,
                                                                init):
    """K4 has a backward: ops.ssd_scan under grad (SSDChunkFn, whose
    backward is K4b's plain version on the CPU) gives the gradients of
    autograd through the plain version (impl="ref"), for every input and
    the initial state; under no_grad it builds no graph."""
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 4, 5
    xs = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(B, S, H, P)), rng.uniform(1e-3, 0.1, (B, S, H)),
        -rng.uniform(0.5, 2.0, (H,)), rng.normal(size=(B, S, N)),
        rng.normal(size=(B, S, N)), rng.normal(size=(B, H, P, N)))]
    if not init:
        xs[5] = None
    cot = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((B, S, H, P), (B, H, P, N))]
    grads = []
    for impl in ("auto", "ref"):
        ins = [None if t is None else t.clone().requires_grad_(True)
               for t in xs]
        y, fin = tops.ssd_scan(*ins[:5], chunk=chunk, init_state=ins[5],
                               impl=impl)
        if impl == "auto":
            assert y.grad_fn is not None
        torch.autograd.backward((y, fin), cot)
        grads.append([t.grad for t in ins if t is not None])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        y, fin = tops.ssd_scan(*[None if t is None else
                                 t.requires_grad_(True) for t in xs][:5],
                               chunk=chunk)
    assert y.grad_fn is None and fin.grad_fn is None
