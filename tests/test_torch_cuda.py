"""The port's CUDA kernels on the card against their plain PyTorch
versions.  Needs an NVIDIA GPU (H100, sm_90a) and nvcc: skipped
elsewhere.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only PyTorch is installed.
Tolerances: float32 atol 2e-3 / rtol 1e-3 (those of tests/test_kernels.py);
bfloat16 atol/rtol 2e-2, since both sides round the output to bf16.  K1's
int8 outputs are compared with torch.equal wherever its epilogue is
piecewise linear.
"""
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import neutron_matmul as t_k1
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as t_ssd

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-3, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (sm_90a)")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,causal,window,dtype", [
    (4, 32, 32, 100, 128, 128, True, None, torch.bfloat16),  # minitron-4b
    (4, 32, 32, 200, 80, 80, True, None, torch.bfloat16),    # zamba2-2.7b
    (2, 4, 4, 70, 80, 80, True, None, torch.float32),
    (2, 4, 2, 100, 32, 32, True, None, torch.float32),
    (2, 4, 2, 100, 32, 32, False, None, torch.float32),
    (1, 4, 2, 77, 16, 16, True, 7, torch.float32),
    (2, 6, 3, 130, 64, 32, True, 40, torch.float32),
    (1, 2, 1, 33, 256, 256, True, None, torch.float32),
    (2, 4, 4, 48, 24, 16, False, None, torch.bfloat16),  # zero-fill to 16
    # bf16 on the tensor cores: query and key tile edges (64), GQA group 3,
    # Dv != D, windows, head dim 256 (32-key tiles)
    (2, 6, 2, 1, 128, 128, True, None, torch.bfloat16),
    (2, 6, 2, 63, 128, 128, True, None, torch.bfloat16),
    (2, 6, 2, 64, 128, 128, True, None, torch.bfloat16),
    (2, 6, 2, 65, 128, 128, True, None, torch.bfloat16),
    (2, 6, 2, 65, 128, 128, False, None, torch.bfloat16),
    (2, 6, 2, 130, 64, 32, True, 40, torch.bfloat16),
    (2, 3, 1, 130, 80, 80, True, 7, torch.bfloat16),
    (1, 4, 2, 77, 16, 16, True, 7, torch.bfloat16),
    (1, 2, 1, 130, 256, 256, True, None, torch.bfloat16),
    (1, 2, 2, 100, 256, 256, False, None, torch.bfloat16),
    # the paths of the zoo: MLA's D = 192 with Dv = 128 (the 192 body,
    # 32-key tiles, V zero-filled past 128), a window of 1024 at S > 1024,
    # MQA's group of 48, granite-moe's head dim 64
    (4, 128, 128, 100, 192, 128, True, None, torch.bfloat16),  # deepseek
    (2, 8, 8, 130, 192, 128, True, None, torch.bfloat16),
    (2, 8, 4, 65, 192, 128, False, None, torch.bfloat16),
    (1, 4, 2, 1040, 128, 128, True, 1024, torch.bfloat16),     # gemma3
    (1, 4, 2, 2100, 128, 128, True, 1024, torch.bfloat16),
    (1, 4, 2, 1040, 128, 128, True, 1024, torch.float32),
    (1, 2, 1, 2100, 128, 128, True, 1024, torch.float32),
    (4, 48, 1, 100, 128, 128, True, None, torch.bfloat16),     # granite-20b
    (4, 16, 8, 100, 64, 64, True, None, torch.bfloat16),       # granite-moe
])
def test_flash_attention_kernel_matches_plain(dev, B, H, Hkv, S, D, Dv,
                                              causal, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(S + D)
    q = _randn(gen, (B, H, S, D), dtype, dev)
    k = _randn(gen, (B, Hkv, S, D), dtype, dev)
    v = _randn(gen, (B, Hkv, S, Dv), dtype, dev)
    n0 = t_fa.launches
    key = t_fa.shape_key(q, k, v, window)
    s0 = t_fa.launches_by_shape[key]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl="ref")
    torch.cuda.synchronize()
    assert t_fa.launches == n0 + 1
    assert t_fa.launches_by_shape[key] == s0 + 1
    assert got.shape == (B, H, S, Dv) and got.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# num_splits gives 1 split at minitron-4b's shape (B 4, Hkv 8, S 116), 2
# at zamba2-2.7b's (bounds 0, 108, 216) and 15 at (2, 2, 1000) (66, 133,
# ...); kv_len sits on both sides of those boundaries.  D = 12 takes the
# body's element-wise loads, the others its 16-byte loads.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,lens", [
    (4, 24, 8, 116, 128, 128, (116, 116, 116, 116)),   # minitron-4b
    (4, 24, 8, 116, 128, 128, (1, 63, 64, 65)),
    (4, 24, 8, 116, 128, 128, (1, 50, 100, 116)),
    (4, 32, 32, 216, 80, 80, (216, 216, 216, 216)),    # zamba2-2.7b
    (4, 32, 32, 216, 80, 80, (107, 108, 109, 1)),
    (2, 6, 2, 1000, 128, 128, (66, 67)),
    (2, 6, 2, 1000, 128, 128, (65, 1000)),
    (2, 4, 4, 150, 80, 80, (150, 3)),
    (3, 4, 2, 300, 32, 32, (1, 129, 300)),
    (2, 4, 2, 64, 24, 16, (40, 9)),
    (2, 4, 2, 70, 12, 20, (70, 33)),
    (2, 8, 1, 513, 256, 256, (513, 257)),              # group 8: 2 blocks
    (4, 48, 1, 116, 128, 128, (116, 116, 116, 116)),   # granite-20b: MQA
    (4, 48, 1, 116, 128, 128, (1, 50, 100, 116)),
    (4, 128, 128, 108, 192, 128, (108, 108, 108, 108)),  # deepseek MLA
    (4, 128, 128, 108, 192, 128, (1, 40, 64, 108)),
    (4, 32, 16, 1024, 128, 128, (1024, 1024, 1024, 1024)),  # gemma3 ring
    (4, 32, 16, 1048, 128, 128, (1048, 1048, 1048, 1048)),  # its global
    (4, 16, 8, 116, 64, 64, (116, 116, 116, 116)),     # granite-moe
])
def test_flash_decode_kernel_matches_plain(dev, B, H, Hkv, S, D, Dv, lens,
                                           dtype):
    """Against the plain version; then a second call on the same split
    scratch gives the same bits (the kernel leaves its tickets at 0)."""
    gen = torch.Generator(device=dev).manual_seed(S + D)
    q = _randn(gen, (B, H, D), dtype, dev)
    k = _randn(gen, (B, Hkv, S, D), dtype, dev)
    v = _randn(gen, (B, Hkv, S, Dv), dtype, dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = t_fd.launches
    key = t_fd.shape_key(q, k, v)
    s0 = t_fd.launches_by_shape[key]
    got, lse = ops.flash_decode(q, k, v, kv_len=kv_len, return_lse=True)
    want, want_lse = ops.flash_decode(q, k, v, kv_len=kv_len,
                                      return_lse=True, impl="ref")
    torch.cuda.synchronize()
    assert t_fd.launches == n0 + 1
    assert t_fd.launches_by_shape[key] == s0 + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=1e-3)
    again, again_lse = ops.flash_decode(q, k, v, kv_len=kv_len,
                                        return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(again, got) and torch.equal(again_lse, lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S", [(4, 24, 8, 116), (2, 6, 2, 1000)])
def test_flash_decode_kernel_empty_cache(dev, B, H, Hkv, S, dtype):
    """kv_len = 0 gives the Pallas kernel's result (the plain version
    gives the mean of v there): output 0 and lse -1e30 + log(1e-30), in
    every split; the other lanes still match the plain version."""
    gen = torch.Generator(device=dev).manual_seed(S)
    q = _randn(gen, (B, H, 128), dtype, dev)
    k = _randn(gen, (B, Hkv, S, 128), dtype, dev)
    v = _randn(gen, (B, Hkv, S, 128), dtype, dev)
    lens = [0, S] * (B // 2)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got, lse = ops.flash_decode(q, k, v, kv_len=kv_len, return_lse=True)
    want, want_lse = ops.flash_decode(q, k, v, kv_len=kv_len,
                                      return_lse=True, impl="ref")
    torch.cuda.synchronize()
    empty = kv_len == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    lse_empty = torch.tensor(-1e30, dtype=torch.float32) + math.log(1e-30)
    assert torch.equal(lse[empty].cpu(),
                       lse_empty.expand(int(empty.sum()), H))
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got[~empty].float(), want[~empty].float(),
                               atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=2e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_on_a_ring_cache_after_the_wrap(dev, dtype):
    """gemma3's local layers: positions 0..1039 written into a ring of
    1024 slots at p % 1024 (kv_len 1024 after the wrap) give what the
    last 1024 positions in order give, on the kernel and the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(1040)
    B, H, Hkv, D, W, P = 4, 32, 16, 128, 1024, 1040
    q = _randn(gen, (B, H, D), dtype, dev)
    k = _randn(gen, (B, Hkv, P, D), dtype, dev)
    v = _randn(gen, (B, Hkv, P, D), dtype, dev)
    slots = torch.arange(P, device=dev) % W
    ring_k = torch.zeros((B, Hkv, W, D), dtype=dtype, device=dev)
    ring_v = torch.zeros_like(ring_k)
    ring_k[:, :, slots[P - W:]] = k[:, :, P - W:]
    ring_v[:, :, slots[P - W:]] = v[:, :, P - W:]
    assert torch.equal(ring_k[:, :, :P - W], k[:, :, W:])   # wrapped
    kv_len = torch.full((B,), W, dtype=torch.int32, device=dev)
    got = ops.flash_decode(q, ring_k, ring_v, kv_len=kv_len)
    want = ops.flash_decode(q, k[:, :, P - W:].contiguous(),
                            v[:, :, P - W:].contiguous(), kv_len=kv_len,
                            impl="ref")
    plain = ops.flash_decode(q, ring_k, ring_v, kv_len=kv_len, impl="ref")
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(plain.float(), want.float(), atol=atol,
                               rtol=rtol)


# k = 0 gives every key a query sees the weight 1/n, so a marker in v
# decides the output: a causal, window or kv_len bound one key off moves
# an output at a marker's edge by about 1 (far above the bf16 tolerance),
# where on random v it moves it by about 1e-3 at these lengths.
@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,window", [
    (4, 32, 16, 1040, 128, 128, 1024),      # gemma3 local
    (2, 32, 16, 2100, 128, 128, 1024),      # the window hides half the keys
    (4, 32, 16, 1040, 128, 128, None),      # gemma3 global
    (4, 128, 128, 100, 192, 128, None),     # deepseek MLA
])
def test_flash_attention_boundary_probe(dev, B, H, Hkv, S, D, Dv, window):
    gen = torch.Generator(device=dev).manual_seed(S)
    q = _randn(gen, (B, H, S, D), torch.bfloat16, dev)
    k = torch.zeros((B, Hkv, S, D), dtype=torch.bfloat16, device=dev)
    v = torch.zeros((B, Hkv, S, Dv), dtype=torch.bfloat16, device=dev)
    v[:, :, ::256] = window or S
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ops.flash_attention(q, k, v, causal=True, window=window,
                               impl="ref")
    if window:
        # a query that sees its whole window gets its markers' count
        t = torch.arange(window - 1, S, device=dev)
        count = (t // 256 - (t - window) // 256).float()
        torch.testing.assert_close(
            got[:, :, window - 1:].float(),
            count[None, None, :, None].expand(B, H, -1, Dv), atol=0,
            rtol=0)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv", [
    (4, 32, 16, 1024, 128, 128),            # gemma3 ring after the wrap
    (4, 48, 1, 116, 128, 128),              # granite-20b: MQA
    (4, 128, 128, 108, 192, 128),           # deepseek MLA
])
def test_flash_decode_kv_len_probe(dev, B, H, Hkv, S, D, Dv):
    """v = 1024 at each lane's last valid key and -2048 at the one after:
    every output is 1024 / kv_len."""
    gen = torch.Generator(device=dev).manual_seed(S)
    q = _randn(gen, (B, H, D), torch.bfloat16, dev)
    k = torch.zeros((B, Hkv, S, D), dtype=torch.bfloat16, device=dev)
    v = torch.zeros((B, Hkv, S, Dv), dtype=torch.bfloat16, device=dev)
    lens = [S, S - 1, S // 2 + 1, 1][:B]
    for b, n in enumerate(lens):
        v[b, :, n - 1] = 1024
        if n < S:
            v[b, :, n] = -2048
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.flash_decode(q, k, v, kv_len=kv_len)
    want = torch.tensor([1024 / n for n in lens], device=dev)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(),
                               want[:, None, None].expand(B, H, Dv),
                               atol=atol, rtol=rtol)
    torch.testing.assert_close(
        got.float(), ops.flash_decode(q, k, v, kv_len=kv_len,
                                      impl="ref").float(),
        atol=atol, rtol=rtol)


def _ssd_inputs(gen, dev, B, S, H, P, N, dtype):
    x = _randn(gen, (B, S, H, P), dtype, dev)
    dt = torch.rand((B, S, H), generator=gen, device=dev) * 0.1 + 1e-3
    A = -(torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
    Bm = _randn(gen, (B, S, N), dtype, dev)
    Cm = _randn(gen, (B, S, N), dtype, dev)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,S,H,P,N,chunk,pad,dtype", [
    (1, 32, 1, 8, 4, 8, 0, torch.float32),
    (2, 128, 3, 16, 8, 32, 28, torch.float32),    # zero rows, as ops pads
    (2, 96, 3, 24, 40, 32, 0, torch.float32),     # N != P, not powers of 2
    (1, 256, 2, 128, 128, 128, 0, torch.float32),  # the largest tile
    (4, 256, 80, 64, 64, 128, 56, torch.bfloat16),  # zamba2-2.7b
    (4, 256, 32, 64, 128, 128, 56, torch.bfloat16),  # mamba2-370m
])
def test_ssd_chunk_kernel_matches_plain(dev, B, S, H, P, N, chunk, pad,
                                        dtype):
    gen = torch.Generator(device=dev).manual_seed(S + H + N)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, dev, B, S, H, P, N, dtype)
    if pad:
        for t in (x, dt, Bm, Cm):
            t[:, S - pad:] = 0
    n0 = t_ssd.launches
    got = t_ssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)
    want = ref.ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert t_ssd.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("S,chunk,init", [(100, 32, False), (37, 16, True)])
def test_ssd_scan_on_the_card_matches_plain(dev, S, chunk, init):
    """ops.ssd_scan pads a ragged S and runs K4 on CUDA tensors."""
    gen = torch.Generator(device=dev).manual_seed(S)
    B, H, P, N = 2, 3, 16, 8
    args = _ssd_inputs(gen, dev, B, S, H, P, N, torch.float32)
    s0 = _randn(gen, (B, H, P, N), torch.float32, dev) if init else None
    n0 = t_ssd.launches
    y, s = ops.ssd_scan(*args, chunk=chunk, init_state=s0)
    y_ref, s_ref = ops.ssd_scan(*args, chunk=chunk, init_state=s0,
                                impl="ref")
    torch.cuda.synchronize()
    assert t_ssd.launches == n0 + 1
    torch.testing.assert_close(y, y_ref, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(s, s_ref, atol=2e-3, rtol=1e-3)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 2, 16, device=dev, dtype=torch.float16)
    k = torch.zeros(1, 2, 8, 16, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_decode(q, k, k)
    q = torch.zeros(1, 2, 8, 12, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.flash_attention(q, q, q)
    x = torch.zeros(1, 16, 2, 8, device=dev, dtype=torch.bfloat16)
    dt = torch.zeros(1, 16, 2, device=dev)
    A = torch.zeros(2, device=dev)
    bc = torch.zeros(1, 16, 4, device=dev)          # f32 while x is bf16
    with pytest.raises(TypeError):
        t_ssd.ssd_chunk(x, dt, A, bc, bc, 16)


# --------------------------------------------------------------------------
# K1 neutron_matmul
# --------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,dtype", [
    (8, 16, 8, torch.float32), (100, 300, 70, torch.float32),
    (33, 65, 129, torch.float32), (128, 512, 128, torch.bfloat16),
    (100, 300, 70, torch.bfloat16),
])
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "mish"])
def test_neutron_matmul_float_matches_plain(dev, M, K, N, dtype, act):
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    x = _randn(gen, (M, K), dtype, dev)
    w = _randn(gen, (K, N), dtype, dev)
    b = _randn(gen, (N,), torch.float32, dev)
    n0 = t_k1.launches
    got = ops.neutron_matmul(x, w, bias=b, scale=0.5, act=act)
    want = ops.neutron_matmul(x, w, bias=b, scale=0.5, act=act, impl="ref")
    torch.cuda.synchronize()
    assert t_k1.launches == n0 + 1
    assert got.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("M,K,N", [(64, 256, 96), (33, 27, 129),
                                   (1, 1280, 1000)])
def test_neutron_matmul_int8_requant_equal(dev, M, K, N):
    gen = torch.Generator(device=dev).manual_seed(K)
    x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    sc = torch.rand((N,), generator=gen, device=dev) * 0.02 + 1e-3
    got = ops.neutron_matmul(x, w, scale=sc, act="relu", out_scale=0.7)
    want = ops.neutron_matmul(x, w, scale=sc, act="relu", out_scale=0.7,
                              impl="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and torch.equal(got, want)
    got = ops.neutron_matmul(x, w, scale=0.02)          # f32 out, scalar
    want = ops.neutron_matmul(x, w, scale=0.02, impl="ref")
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("B,R,C,K,N,stride,act", [
    (3, 9, 9, 20, 12, 2, "relu"),       # strided 1x1 conv, in place
    (2, 14, 14, 27, 32, 1, "relu6"),    # K = 27, the mobilenet stem
    (1, 7, 7, 147, 64, 1, "none"),      # K = 147, the resnet50 stem
    (5, 4, 4, 576, 70, 1, "hswish"),    # ragged N
    (2, 3, 5, 4608, 130, 1, "leaky"),   # K = 4608
    (2, 6, 6, 64, 24, 1, "silu"),
])
def test_neutron_matmul_plan_matches_plain(dev, B, R, C, K, N, stride, act):
    """The plan contract: operands read through a strided view of a wider
    buffer (the arena's row pitch), the output written in place into a
    view of another; equal to the plain version (one step for silu)."""
    gen = torch.Generator(device=dev).manual_seed(K + N)
    pitch = R * C * K + 192
    arena = torch.randint(-128, 128, (B, pitch), generator=gen, device=dev,
                          dtype=torch.int8)
    x = arena[:, 64:64 + R * C * K].view(B, R, C, K)[:, ::stride, ::stride]
    Ro, Co = x.shape[1], x.shape[2]
    w = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                      dtype=torch.int8)
    bias = torch.randint(-5000, 5000, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    sc = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-5
    out_arena = torch.zeros((B, Ro * Co * N + 128), device=dev,
                            dtype=torch.int8)
    out = out_arena[:, 64:64 + Ro * Co * N].view(B, Ro * Co, N)
    n0 = t_k1.launches
    ops.neutron_matmul_plan(x, w, bias, sc, act, 0.05, -3, -128, 127, out)
    want = ops.neutron_matmul_plan(x, w, bias, sc, act, 0.05, -3, -128, 127,
                                   torch.empty_like(out), impl="ref")
    torch.cuda.synchronize()
    assert t_k1.launches == n0 + 1
    diff = (out.int() - want.int()).abs()
    assert int(diff.max()) <= (1 if act == "silu" else 0)
    assert not out_arena[:, :64].any() and not out_arena[:, -64:].any()


def test_vision_plan_on_the_card_equals_cpu(dev):
    """mobilenet_v2 at res_scale 0.25: the plan on the card stores the
    same integers as the plain path on the CPU, at batch 1 and a ragged 5
    in an 8-plan; every conv and fc (35 + 1) ran on K1."""
    import numpy as np
    from repro_torch.core.execplan import lower_plan
    from repro_torch.frontends import vision
    from repro_torch.quant import QuantSemantics

    g, _, qm = vision.build_quantized("mobilenet_v2", res_scale=0.25)
    plans = {d: lower_plan(None, g, None, qm.weights_f, QuantSemantics(qm),
                           capacity=8, device=d) for d in ("cpu", dev)}
    inp = g.inputs[0]
    xs = np.random.default_rng(1).normal(
        size=(5,) + inp.shape).astype(np.float32)
    for n in (1, 5):
        n0 = t_k1.launches
        got = plans[dev].run({inp.name: xs[:n]}, n=n, decode=False)
        torch.cuda.synchronize()
        assert t_k1.launches == n0 + 36
        want = plans["cpu"].run({inp.name: xs[:n]}, n=n, decode=False)
        for name, w in want.items():
            assert torch.equal(got[name].cpu(), w), (name, n)


def test_plan_divisions_on_the_card_are_correctly_rounded(dev):
    """Where a multiply by the float32 reciprocal of s_out would round
    y / s_out to the other integer (a tenth of these columns), K1 and
    quantize_t on the card give numpy's correctly rounded quotient."""
    import numpy as np
    from repro_torch.core.ir import QParams
    from repro_torch.quant.qparams import quantize_t

    rng = np.random.default_rng(0)
    s_out = np.float32(0.037)
    bias = rng.integers(1000, 100000, size=512).astype(np.int32)
    k = rng.integers(-100, 100, size=512)
    sc = ((k + 0.5) * float(s_out) / bias).astype(np.float32)
    y = bias.astype(np.float32) * sc
    want = np.clip(np.round(y / s_out), -128, 127).astype(np.int8)
    assert (np.round(y / s_out) != np.round(y * (1 / s_out))).sum() > 10
    n = len(bias)
    out = torch.empty((1, 1, n), dtype=torch.int8, device=dev)
    ops.neutron_matmul_plan(
        torch.zeros((1, 1, 4), dtype=torch.int8, device=dev),
        torch.zeros((n, 4), dtype=torch.int8, device=dev),
        torch.from_numpy(bias).to(dev), torch.from_numpy(sc).to(dev),
        "none", float(s_out), 0, -128, 127, out)
    got = quantize_t(torch.from_numpy(y).to(dev),
                     QParams(s_out, np.int64(0), bits=8))
    torch.cuda.synchronize()
    assert np.array_equal(out.cpu().numpy()[0, 0], want)
    assert np.array_equal(got.cpu().numpy(), want)


# --------------------------------------------------------------------------
# K1's int8 body on the tensor cores: load widths, span mode, split-K
# --------------------------------------------------------------------------


def _k1_plan_of(x, w):
    B, M, K, xb, x_ow, x_sy, x_sx = t_k1._rows(x)
    return t_k1.plan(B, M, w.shape[0], K, xb, x_ow, x_sy, x_sx,
                     x.data_ptr(), w.data_ptr())


def _k1_case(dev, gen, B, R, C, K, N, stride, fill=None):
    """x as a strided view of an arena slot of B rows at a 64-byte
    aligned pitch (R x C positions of K channels, every `stride`-th),
    w (N, K), bias, sc and an output view into another arena."""
    pitch = -(-(R * C * K + 128) // 64) * 64
    arena = torch.randint(-128, 128, (B, pitch), generator=gen, device=dev,
                          dtype=torch.int8)
    if fill is not None:
        arena.fill_(fill)
    x = arena[:, 64:64 + R * C * K].view(B, R, C, K)[:, ::stride, ::stride]
    w = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                      dtype=torch.int8)
    if fill is not None:
        w.fill_(fill)
    Ro, Co = x.shape[1], x.shape[2]
    bias = torch.randint(-5000, 5000, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    # rescale so that act(y) spans a few output steps: with every operand
    # -128 the accumulators are K * 16384, else about sqrt(K) * 5461
    sc = (torch.rand((N,), generator=gen, device=dev) + 0.5) \
        * (0.2 / (K * 16384) if fill is not None
           else 2.0 / (math.sqrt(K) * 5461))
    out = torch.zeros((B, Ro * Co * N + 128), device=dev, dtype=torch.int8)
    return x, w, bias, sc, out[:, 64:64 + Ro * Co * N].view(B, Ro * Co, N)


@pytest.mark.parametrize("B,R,C,K,N,stride,act,fill,load,split", [
    # mobilenet_v2's strided 1x1 over C = 24: rows 48 bytes apart
    (8, 14, 14, 24, 32, 2, "relu6", None, 8, False),
    (8, 28, 28, 24, 144, 2, "none", None, 8, False),
    # a batch-8 fc, M = 1 per image: one 8-row product, split along K
    (8, 1, 1, 1280, 1000, 1, "none", None, 16, True),
    (8, 1, 1, 2048, 1000, 1, "none", None, 16, True),
    # resnet50_v1's M = 49 convs, K = 2304 and 4608: split-K
    (8, 7, 7, 2304, 256, 1, "relu", None, 16, True),
    (8, 7, 7, 4608, 512, 1, "relu", None, 16, True),
    # N not a multiple of 8, K = 20 (4-byte copies), K odd (byte loads)
    (8, 7, 7, 576, 70, 1, "hswish", None, 16, True),
    (3, 9, 9, 20, 12, 2, "leaky", None, 4, False),
    (2, 5, 5, 33, 19, 2, "relu", None, 1, False),
    # the largest accumulator: every operand -128 at K = 4608
    (8, 7, 7, 4608, 64, 1, "none", -128, 16, True),
])
def test_neutron_matmul_plan_tensor_core_cases(dev, B, R, C, K, N, stride,
                                               act, fill, load, split):
    """The int8 body at the load width, span mode and split its plan
    picks for each layout, equal to the plain version; a second call on
    the same split scratch gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(K + N + R)
    x, w, bias, sc, out = _k1_case(dev, gen, B, R, C, K, N, stride, fill)
    pl = _k1_plan_of(x, w)
    assert pl.load == load and (pl.splits > 1) == split
    args = (x, w, bias, sc, act, 0.05, -3, -128, 127)
    n0 = t_k1.launches
    ops.neutron_matmul_plan(*args, out)
    want = ops.neutron_matmul_plan(*args, torch.empty_like(out), impl="ref")
    torch.cuda.synchronize()
    assert t_k1.launches == n0 + 1
    assert torch.equal(out, want)
    again = torch.zeros_like(out)
    ops.neutron_matmul_plan(*args, again)
    torch.cuda.synchronize()
    assert torch.equal(again, out)


@pytest.mark.parametrize("M,K,N", [(8, 27, 32), (200, 147, 64),
                                   (64, 160, 40), (33, 24, 17)])
def test_neutron_matmul_span_mode_matches_plain(dev, M, K, N):
    """Contiguous rows of K <= 160 not a multiple of 16 (the stems' im2col
    buffers) go through span mode, in both contracts."""
    gen = torch.Generator(device=dev).manual_seed(M + K)
    x = torch.randint(-128, 128, (2, M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                      dtype=torch.int8)
    assert _k1_plan_of(x, w).load == t_k1.SPAN or K % 16 == 0
    bias = torch.randint(-5000, 5000, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    sc = torch.rand((N,), generator=gen, device=dev) * 1e-3 + 1e-5
    out = torch.empty((2, M, N), dtype=torch.int8, device=dev)
    args = (x, w, bias, sc, "relu", 0.05, 2, -128, 127)
    ops.neutron_matmul_plan(*args, out)
    want = ops.neutron_matmul_plan(*args, torch.empty_like(out), impl="ref")
    x2, w2 = x[0], w.t().contiguous()
    got2 = ops.neutron_matmul(x2, w2, scale=0.01, act="relu", out_scale=0.5)
    want2 = ops.neutron_matmul(x2, w2, scale=0.01, act="relu", out_scale=0.5,
                               impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(got2, want2)


@pytest.mark.parametrize("B,H,group", [(2, 3, 1), (2, 5, 1), (100, 3, 2),
                                       (66, 5, 2), (100, 5, 4)])
@pytest.mark.parametrize("pad", [0, 20])
def test_ssd_chunk_bf16_small_matches_plain(dev, B, H, group, pad):
    """The bf16 tensor-core body at L = 32, N = 40, P = 24 (zero-filled to
    48 and 32 in shared memory), one chunk of 32 per sequence; enough
    sequences that ``head_group`` gives groups of 2 and 4 heads, which do
    not divide H; outputs f32 within atol 2e-3 / rtol 1e-3."""
    S, P, N, chunk = 32, 24, 40, 32
    assert t_ssd.head_group(B, H) == group
    gen = torch.Generator(device=dev).manual_seed(B + H + pad)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, dev, B, S, H, P, N, torch.bfloat16)
    if pad:
        for t in (x, dt, Bm, Cm):
            t[:, S - pad:] = 0
    n0 = t_ssd.launches
    got = t_ssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)
    want = ref.ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert t_ssd.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-3)
