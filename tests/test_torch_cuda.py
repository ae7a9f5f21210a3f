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
import time

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
    (4, 6, 6, 48, 64, 64, (48, 48, 48, 48)),           # whisper-tiny
    (4, 6, 6, 48, 64, 64, (1, 16, 17, 48)),
    (4, 12, 2, 304, 128, 128, (304, 304, 304, 304)),   # qwen2-vl-2b
    (4, 12, 2, 304, 128, 128, (1, 256, 257, 304)),
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


# K4b at chip_smoke.py's rows (the training shapes, batch 8 x 128: one
# chunk; the serving prefill shapes: two chunks, 56 zero rows) and small
# float32 cases (ragged tiles, zero rows, N != P, the largest tile)
SSD_BWD_CASES = [
    (8, 128, 32, 64, 128, 128, 0, torch.bfloat16),   # mamba2-370m training
    (8, 128, 80, 64, 64, 128, 0, torch.bfloat16),    # zamba2-2.7b training
    (4, 256, 80, 64, 64, 128, 56, torch.bfloat16),   # zamba2-2.7b serving
    (4, 256, 32, 64, 128, 128, 56, torch.bfloat16),  # mamba2-370m serving
    (1, 32, 1, 8, 4, 8, 0, torch.float32),
    (2, 128, 3, 16, 8, 32, 28, torch.float32),
    (2, 96, 3, 24, 40, 32, 0, torch.float32),
    (1, 256, 2, 128, 128, 128, 0, torch.float32),
    # the bf16 tensor-core body at N 40, P 24, L 32 (zero-filled to 48, 32,
    # 32 in shared memory), one chunk a sequence; enough (b, c) pairs that
    # bwd_head_group gives groups of 2 and 4 that do not divide H; zero
    # rows; and P 128 with N 128, whose buffers do not fit a block (the
    # scalar body in bf16)
    (2, 32, 3, 24, 40, 32, 0, torch.bfloat16),
    (100, 32, 3, 24, 40, 32, 20, torch.bfloat16),    # group 2 of 3
    (66, 32, 5, 24, 40, 32, 0, torch.bfloat16),      # group 2 of 5
    (100, 32, 5, 24, 40, 32, 20, torch.bfloat16),    # group 4 of 5
    (2, 96, 3, 24, 40, 32, 28, torch.bfloat16),      # nc 3
    (2, 80, 3, 24, 40, 40, 12, torch.bfloat16),      # chunk 40: 3 row tiles
    (2, 32, 3, 16, 8, 8, 0, torch.bfloat16),         # chunk 8: one row tile
    (1, 256, 2, 128, 128, 128, 0, torch.bfloat16),
]


def _ssd_cotangents(gen, dev, B, S, H, P, N, chunk):
    nc = S // chunk
    return (_randn(gen, (B, S, H, P), torch.float32, dev),
            _randn(gen, (B, nc, H, P, N), torch.float32, dev),
            _randn(gen, (B, nc, H), torch.float32, dev),
            _randn(gen, (B, S, H), torch.float32, dev))


@pytest.mark.parametrize("B,S,H,P,N,chunk,pad,dtype", SSD_BWD_CASES)
def test_ssd_chunk_bwd_kernel_matches_plain(dev, B, S, H, P, N, chunk, pad,
                                            dtype):
    """K4b against ssd_chunk_bwd_ref on K4's own seg: per gradient
    max|d| / max|plain| below 1e-4, for bf16 inputs as for float32 ones
    (both sides do float32 arithmetic on the same input bits and float32
    cotangents, so a kernel that rounded the cotangents or its partial
    products to bf16 fails, and so would plain TF32 products: 4e-4 to
    1e-3 in the CPU emulation of tests/test_torch_ssd_bwd.py, where the
    3xTF32 plan of the bf16 body stays near 1e-6); a rerun gives the same
    bits (no atomics)."""
    from repro_torch.kernels import ssd_scan_bwd as t_ssdb
    gen = torch.Generator(device=dev).manual_seed(S + H + N + 1)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, dev, B, S, H, P, N, dtype)
    if pad:
        for t in (x, dt, Bm, Cm):
            t[:, S - pad:] = 0
    seg = t_ssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)[3]
    cot = _ssd_cotangents(gen, dev, B, S, H, P, N, chunk)
    n0 = t_ssdb.launches
    got = t_ssdb.ssd_chunk_bwd(x, dt, A, Bm, Cm, seg, *cot, chunk)
    want = ref.ssd_chunk_bwd_ref(x, dt, A, Bm, Cm, seg, *cot, chunk)
    torch.cuda.synchronize()
    assert t_ssdb.launches == n0 + 1
    for name, g, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel < 1e-4, (name, rel)
    if pad:                     # the zero rows carry no gradient to x
        assert not got[0][:, S - pad:].any()
    again = t_ssdb.ssd_chunk_bwd(x, dt, A, Bm, Cm, seg, *cot, chunk)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("S,chunk,init,dtype", [
    (100, 32, True, torch.float32), (37, 16, False, torch.float32),
    (70, 32, True, torch.bfloat16)])
def test_ssd_scan_grad_on_the_card_matches_the_cpu(dev, S, chunk, init,
                                                   dtype):
    """ops.ssd_scan under grad on CUDA (SSDChunkFn: K4, then K4b; the
    recurrence through autograd) and on the CPU (the plain versions) from
    the same inputs and cotangents: float32 within atol 2e-3 / rtol 1e-3,
    bf16 within 2e-2 of each gradient's max."""
    from repro_torch.kernels import ssd_scan_bwd as t_ssdb
    gen = torch.Generator().manual_seed(S)
    B, H, P, N = 2, 3, 16, 8
    xs = _ssd_inputs(gen, "cpu", B, S, H, P, N, dtype)
    s0 = torch.randn(B, H, P, N, generator=gen).to(dtype) if init else None
    dy = torch.randn(B, S, H, P, generator=gen).to(dtype)
    ds = torch.randn(B, H, P, N, generator=gen).to(dtype)
    grads = []
    for d in ("cpu", dev):
        ins = [t.detach().to(d).requires_grad_(True) for t in xs]
        st = None if s0 is None else \
            s0.detach().to(d).requires_grad_(True)
        n0 = (t_ssd.launches, t_ssdb.launches)
        y, fin = ops.ssd_scan(*ins, chunk=chunk, init_state=st)
        torch.autograd.backward((y, fin), (dy.to(d), ds.to(d)))
        if d != "cpu":
            assert (t_ssd.launches, t_ssdb.launches) == (n0[0] + 1, n0[1] + 1)
        grads.append([y.detach().cpu(), fin.detach().cpu()]
                     + [t.grad.cpu() for t in ins]
                     + ([] if st is None else [st.grad.cpu()]))
    for a, b in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(b, a, atol=2e-3, rtol=1e-3)
        else:
            a, b = a.float(), b.float()
            assert float((a - b).abs().max() / a.abs().max()) < 2e-2


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


# --------------------------------------------------------------------------
# K1's float32 Pallas contract and the Session on the card (ROADMAP 6b, 7)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,R,C,K,N,stride,act", [
    (8, 112, 112, 27, 32, 1, "relu6"),     # mobilenet_v2 stem (im2col)
    (8, 7, 7, 320, 1280, 1, "relu6"),      # mobilenet_v2 last 1x1
    (8, 1, 1, 1280, 1000, 1, "none"),      # mobilenet_v2 fc
    (3, 14, 14, 96, 40, 2, "hswish"),      # 1x1 stride 2, read in place
    (2, 9, 9, 33, 70, 1, "gelu"),
])
def test_neutron_matmul_nk_matches_plain(dev, B, R, C, K, N, stride, act):
    """K1 in its Pallas contract with float32 operands and an (N, K)
    weight, as the float32 plan calls it: x a strided view, the output
    written in place at a row pitch; f32 atol 2e-3 / rtol 1e-3 against
    the plain version (cuBLAS, TF32 off)."""
    gen = torch.Generator(device=dev).manual_seed(K + N)
    x = _randn(gen, (B, R * stride, C * stride, K), torch.float32, dev)
    xin = x[:, ::stride, ::stride, :]
    wt = _randn(gen, (N, K), torch.float32, dev) / math.sqrt(K)
    bias = _randn(gen, (N,), torch.float32, dev)
    buf = torch.zeros((B, R * C + 3, N), dtype=torch.float32, device=dev)
    out = buf[:, :R * C]
    n0 = t_k1.launches
    c0 = t_k1.launches_by_contract["pallas float32"]
    ops.neutron_matmul_nk(xin, wt, bias, act, out)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ref.neutron_matmul_nk_ref(xin, wt, bias, act)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.synchronize()
    assert t_k1.launches == n0 + 1
    assert t_k1.launches_by_contract["pallas float32"] == c0 + 1
    torch.testing.assert_close(out, want, atol=2e-3, rtol=1e-3)
    assert not buf[:, R * C:].any()


def _no_tf32(fn):
    """``fn()`` with cuBLAS's float32 products held out of TF32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("B,R,C,K,N,stride,act", [
    # rows over batch * M across the skinny / tiled edge (16)
    (1, 15, 1, 64, 40, 1, "relu"), (2, 8, 1, 64, 40, 1, "none"),
    (17, 1, 1, 64, 40, 1, "relu6"), (1, 63, 1, 96, 70, 1, "gelu"),
    (1, 64, 1, 96, 70, 1, "hswish"), (5, 13, 1, 96, 70, 1, "silu"),
    # ragged K (4-byte copies) and N, one column, a 32-wide tile
    (1, 1, 1, 27, 1, 1, "mish"), (3, 3, 3, 27, 33, 1, "leaky"),
    (2, 20, 1, 1001, 129, 1, "sigmoid"), (1, 100, 1, 27, 32, 1, "relu6"),
    # a strided 1x1 view of an arena slot; K split over blocks
    (3, 7, 7, 96, 40, 2, "hsigmoid"), (1, 20, 1, 2000, 40, 1, "sqrelu"),
    (8, 1, 1, 1280, 1000, 1, "none"), (1, 1, 1, 1536, 384, 1, "none"),
])
def test_neutron_matmul_nk_routes(dev, B, R, C, K, N, stride, act):
    """K1's float32 body on both routes of ``float_plan`` (skinny up to 16
    rows over batch * M, tiled 3xTF32 above): x a view, the output written
    in place at an odd row pitch, bias and each activation class; f32 atol
    2e-3 / rtol 1e-3 and ``float_plan_tol`` against the plain version
    (TF32 off), nothing past the output's columns written, and a rerun
    bit-equal."""
    from repro_torch.core.executor import float_plan_tol
    s = stride
    gen = torch.Generator(device=dev).manual_seed(K * 7 + N)
    x = _randn(gen, (B, R * s, C * s, K), torch.float32, dev)
    xin = x[:, ::s, ::s, :]
    wt = _randn(gen, (N, K), torch.float32, dev) / math.sqrt(K)
    bias = _randn(gen, (N,), torch.float32, dev)
    buf = torch.zeros((B, R * C, N + 1), dtype=torch.float32, device=dev)
    out = buf[:, :, :N]
    rows = t_k1._rows(xin)
    fp = t_k1.float_plan(B, R * C, N, K, (rows[3], rows[5], rows[6]),
                         (xin.data_ptr(), wt.data_ptr()))
    assert fp.route == (t_k1.SKINNY if B * R * C <= 16 else t_k1.TILED)
    n0 = t_k1.launches
    ops.neutron_matmul_nk(xin, wt, bias, act, out)
    first = out.clone()
    ops.neutron_matmul_nk(xin, wt, bias, act, out)
    want = _no_tf32(lambda: ref.neutron_matmul_nk_ref(xin, wt, bias, act))
    torch.cuda.synchronize()
    assert t_k1.launches == n0 + 2
    torch.testing.assert_close(first, want.view(B, R * C, N), atol=2e-3,
                               rtol=1e-3)
    # the float32 plan's limit, which plain TF32 products would break
    err = float((first - want.view(B, R * C, N)).abs().max())
    assert err <= float_plan_tol(want.cpu().numpy())
    assert torch.equal(first, out)
    assert not buf[:, :, N].any()


@pytest.mark.parametrize("M,K,N", [(8, 64, 40), (16, 520, 24),
                                   (100, 300, 70), (33, 27, 129)])
def test_neutron_matmul_bf16_routes(dev, M, K, N):
    """bf16 inputs of the Pallas contract take the same routes: skinny
    FMAs, and the tiled route's TF32 products, exact on bf16 values, so
    within ``float_plan_tol`` of the f32 plain version."""
    from repro_torch.core.executor import float_plan_tol
    gen = torch.Generator(device=dev).manual_seed(M * K + N)
    x = _randn(gen, (M, K), torch.bfloat16, dev)
    w = _randn(gen, (K, N), torch.bfloat16, dev)
    b = _randn(gen, (N,), torch.float32, dev)
    got = ops.neutron_matmul(x, w, bias=b, act="relu", out_dtype=torch.float32)
    again = ops.neutron_matmul(x, w, bias=b, act="relu",
                               out_dtype=torch.float32)
    want = _no_tf32(lambda: ops.neutron_matmul(
        x, w, bias=b, act="relu", out_dtype=torch.float32, impl="ref"))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)
    assert float((got - want).abs().max()) <= float_plan_tol(
        want.cpu().numpy())
    assert torch.equal(got, again)


def test_neutron_matmul_launch_refuses_a_broken_float_plan(dev,
                                                          monkeypatch):
    """The C side holds a float call to what its plan promised: a skinny
    route at more than 16 rows, or 16-byte loads at an odd K, are refused
    with cudaErrorInvalidValue, and nothing launches."""
    x = torch.zeros((1, 20, 27), device=dev)
    wt = torch.zeros((8, 27), device=dev)
    out = torch.zeros((1, 20, 8), device=dev)
    for plan in (t_k1.FloatPlan(t_k1.SKINNY, 16, 4, 1),
                 t_k1.FloatPlan(t_k1.TILED, 64, 16, 1),
                 t_k1.FloatPlan(t_k1.TILED, 48, 4, 1)):
        monkeypatch.setattr(t_k1, "float_plan",
                            lambda *a, plan=plan, **k: plan)
        n0 = t_k1.launches
        with pytest.raises(RuntimeError, match="invalid argument"):
            t_k1.neutron_matmul_nk(x, wt, None, "none", out)
        assert t_k1.launches == n0


def _served_graph(name: str, seed: int = 0):
    """A small graph of every vision kind the plans lower, built with the
    port's GraphBuilder (this file imports no JAX)."""
    from repro_torch.core.ir import GraphBuilder
    b = GraphBuilder(name, seed=seed)
    x = b.input((16, 16, 8))
    x = b.conv(x, 16, k=3, act="relu")
    y = b.dwconv(x, k=3, act="relu6")
    x = b.add(x, y, act="relu")
    x = b.conv(x, 16, k=1, s=2, act="silu")
    x = b.maxpool(x, k=2)
    x = b.scalar(x, "mul", 0.5)
    x = b.activation(x, "hswish")
    lo, hi = b.split(x, 2)
    x = b.concat([lo, hi])
    x = b.resize(x, 2)
    x = b.global_avgpool(x)
    b.mark_output(b.fc(x, 10))
    return b.build(), b


def _session_models(device, precision):
    import repro_torch.api as tapi
    return tapi.compile(_served_graph(f"served_{precision}"),
                        precision=precision, calib_samples=2, cache=False,
                        device=device)


def test_session_on_the_card_serves_int8_and_float32(dev):
    """Two worker threads, each on its own stream, serve an int8 and a
    float32 model: int8 outputs equal the plain path's on the CPU, the
    float32 ones lie within ``float_plan_tol`` of it; every conv and fc
    of every batch ran on K1."""
    import numpy as np
    import repro_torch.api as tapi
    from repro_torch.core.executor import float_plan_tol

    sess = tapi.Session(workers=2, max_batch=4, linger_ms=1.0)
    try:
        cpu = {}
        for p in ("int8", "float32"):
            sess.add(_session_models(dev, p), name=p)
            cpu[p] = _session_models("cpu", p)
        convs = sum(op.kind in ("conv", "fc")
                    for op in sess["int8"].graph.ops)
        xs = np.random.default_rng(0).normal(
            size=(24, 16, 16, 8)).astype(np.float32)
        n0 = t_k1.launches
        tickets = [(p, i, sess.submit(p, xs[i]))
                   for i in range(24) for p in ("int8", "float32")]
        for p, i, t in tickets:
            got = t.result(timeout=60)
            want = cpu[p].run_many([xs[i]])[0]
            for k, w in want.items():
                assert got[k].device.type == "cpu"
                if p == "int8":
                    assert torch.equal(got[k], w), (p, i, k)
                else:
                    err = float((got[k] - w).abs().max())
                    assert err <= float_plan_tol(w.numpy()), (p, i, k, err)
        st = sess.stats()
        batches = sum(st["models"][p]["batches"] for p in cpu)
        assert t_k1.launches - n0 == convs * batches
        streams = [h["stream"] for h in st["workers"].values()]
        assert None not in streams and len(set(streams)) == 2
    finally:
        sess.close()


def test_session_batch_phases_on_the_card(dev):
    """With the tracer armed, a batch of 4 on a one-worker pool records
    ``copy_back`` (the device-to-host copies, after the stream's last
    kernels) after ``decode`` inside its ``batch`` span, every phase with
    the batch's id; ``stage.copy_in`` counts the images' bytes."""
    import numpy as np
    import repro_torch.api as tapi
    from repro_torch.obs import trace

    sess = tapi.Session(workers=1, max_batch=4, linger_ms=5000.0)
    tr = trace.enable()
    try:
        sess.add(_session_models(dev, "int8"), name="int8")
        xs = np.random.default_rng(0).normal(
            size=(4, 16, 16, 8)).astype(np.float32)
        tr.clear()
        for t in [sess.submit("int8", x) for x in xs]:
            t.result(timeout=60)
    finally:
        trace.disable()
        sess.close()
    spans = {e[0]: e for e in tr.events() if e[1] == "serving"
             and e[0] != "serve"}
    batch = spans["batch"]
    for name in ("stage.stack", "stage.copy_in", "stage.encode", "decode",
                 "copy_back"):
        e = spans[name]
        assert batch[2] <= e[2] <= e[3] <= batch[3], name
        assert e[7]["batch"] == batch[7]["batch"] is not None
    assert spans["decode"][3] <= spans["copy_back"][2]
    assert spans["settle"][2] >= batch[3]
    assert "drain" not in spans
    assert spans["stage.copy_in"][7] == {"bytes": xs.nbytes,
                                         "batch": batch[7]["batch"]}


def test_session_sync_launch_error_fails_only_its_batch(dev):
    """A launch that the launch function refuses at once
    (``cudaErrorInvalidValue``, a synchronous error), on one worker's
    stream behind kernels still running there (a long
    ``torch.cuda._sleep``), fails the tickets of that batch (and of its
    retry on the same stream) and no other: every other ticket equals
    the plain path's ints.  An asynchronous device fault (an illegal
    address, a trap) is not injected: it is sticky and poisons the CUDA
    context of every worker of the process."""
    import threading

    import numpy as np
    import repro_torch.api as tapi
    from repro_torch.kernels import _build

    sess = tapi.Session(workers=2, max_batch=4, linger_ms=1.0,
                        retry_backoff_ms=1.0, breaker_threshold=100)
    try:
        model = sess.add(_session_models(dev, "int8"), name="m")
        cpu = _session_models("cpu", "int8")
        st = model.lower()[0][0]              # the first conv: K1
        orig, lock = st.run, threading.Lock()
        poison = {"stream": None, "left": 2}
        fn = _build.function("neutron_matmul", "neutron_matmul_launch",
                             t_k1._ARGTYPES)

        def faulty(bufs, n):
            s = torch.cuda.current_stream().cuda_stream
            with lock:
                hit = poison["left"] > 0 and poison["stream"] in (None, s)
                if hit:
                    poison["stream"] = s
                    poison["left"] -= 1
            orig(bufs, n)
            if hit:
                torch.cuda._sleep(50_000_000)
                # batch 0: the launch function refuses the launch with
                # cudaErrorInvalidValue, and the wrapper's check raises
                rc = fn(*([None] * 5 + [0, 1, 1, 1] + [0, 1, 0, 0, 0, 1]
                          + [0] * 6 + [1.0] + [0] * 7 + [None, None, s]))
                _build.check(rc, "neutron_matmul")
        st.run = faulty
        xs = np.random.default_rng(2).normal(
            size=(32, 16, 16, 8)).astype(np.float32)
        tickets = [sess.submit("m", x) for x in xs]
        failed = []
        for i, t in enumerate(tickets):
            try:
                got = t.result(timeout=60)
            except Exception as e:
                failed.append(e)
                continue
            for k, w in cpu.run_many([xs[i]])[0].items():
                assert torch.equal(got[k], w), (i, k)
        assert poison["left"] == 0
        assert 1 <= len(failed) <= 4
        assert len({id(e) for e in failed}) == 1       # one batch's error
        assert "CUDA error" in str(failed[0])
        assert sess.stats()["models"]["m"]["retries"] >= 1
    finally:
        sess.close()


def test_session_open_breaker_on_the_card_fails_fast_then_recovers(dev):
    """On a CUDA session the open breaker fails a batch fast with
    ``BreakerOpen`` and a retry hint, launching nothing and serving
    nothing from the host; the probe then verifies the re-lowered plan on
    the card, and the model serves the plain path's ints on K1 again."""
    import numpy as np
    import repro_torch.api as tapi
    import repro_torch.runtime.chaos as chaos

    sess = tapi.Session(workers=1, max_batch=4, linger_ms=1.0,
                        retry_backoff_ms=1.0, breaker_threshold=2,
                        breaker_cooldown_s=1.0)
    try:
        model = sess.add(_session_models(dev, "int8"), name="m")
        cpu = _session_models("cpu", "int8")
        convs = sum(op.kind in ("conv", "fc") for op in model.graph.ops)
        x = np.random.default_rng(3).normal(
            size=(16, 16, 8)).astype(np.float32)
        want = cpu.run_many([x])[0]
        with chaos.inject() as c:
            for _ in range(2):
                c.poison_plan("m", times=2)
                with pytest.raises(chaos.ChaosError):
                    sess.submit("m", x).result(timeout=60)
            n0 = t_k1.launches
            with pytest.raises(tapi.BreakerOpen) as e:
                sess.submit("m", x).result(timeout=60)
            assert t_k1.launches == n0
        assert 0 < e.value.retry_after_ms <= 1e3
        st = sess.stats()["models"]["m"]
        assert st["breaker_rejects"] == 1 and st["degraded_requests"] == 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                sess.stats()["models"]["m"]["recoveries"]):
            time.sleep(0.05)
        assert sess.stats()["models"]["m"]["breaker"]["state"] == "closed"
        n0 = t_k1.launches
        got = sess.submit("m", x).result(timeout=60)
        assert t_k1.launches - n0 == convs
        for k, w in want.items():
            assert torch.equal(got[k], w), k
    finally:
        sess.close()


# --------------------------------------------------------------------------
# the LM decode path on the NPU compile path (ROADMAP item 8)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Sk,causal", [
    (3, 8, 16, True), (3, 8, 16, False), (4, 64, 128, True),
    (3, 1, 8, True), (2, 5, 70, True), (2, 130, 200, True),
])
def test_flash_attention_q_offset_matches_plain(dev, dtype, B, S, Sk,
                                                causal):
    """K2 with a per-lane query offset: lanes at 0, 3 and Sk - S (the
    extremes and a middle) in one launch, 6 heads of 64 as the decoder
    runs them (and a ragged S past one query tile), against the plain
    version; the offset 0 against no offset at all."""
    gen = torch.Generator(device=dev).manual_seed(S + Sk)
    H, D = 6, 64
    q = _randn(gen, (B, H, S, D), dtype, dev)
    k = _randn(gen, (B, H, Sk, D), dtype, dev)
    v = _randn(gen, (B, H, Sk, D), dtype, dev)
    offs = [(0, 3, Sk - S)[b % 3] for b in range(B)]
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    n0 = t_fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    want = ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                               impl="ref")
    torch.cuda.synchronize()
    assert t_fa.launches == n0 + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    if causal:      # at offset 0 the kernel's mask already ends at S
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, causal=True, q_offset=zero),
            ops.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("kv", [8, 16, 128])
def test_flash_decode_f32_decoder_shapes(dev, kv):
    """K3 in float32 at the decoder's heads (H = Hkv = 6, D 64), kv_len
    at 1, in the middle and at the full bucket, over three lanes."""
    gen = torch.Generator(device=dev).manual_seed(kv)
    q = _randn(gen, (3, 6, 64), torch.float32, dev)
    k = _randn(gen, (3, 6, kv, 64), torch.float32, dev)
    v = _randn(gen, (3, 6, kv, 64), torch.float32, dev)
    kv_len = torch.tensor([1, kv // 2 + 1, kv], dtype=torch.int32,
                          device=dev)
    got = ops.flash_decode(q, k, v, kv_len=kv_len, sm_scale=0.125)
    want = ops.flash_decode(q, k, v, kv_len=kv_len, sm_scale=0.125,
                            impl="ref")
    torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("M", [1, 64])
def test_neutron_matmul_logits_width_into_strided_output(dev, M):
    """K1 at the decoder's logits (K 384, N 51865: not a multiple of the
    64-wide tile, an odd int8 row pitch), both contracts, the output a
    view at a batch stride of a wider buffer (the arena's): the plan
    contract's ints equal the plain version's, the float32 contract
    within 2e-3 / 1e-3, nothing written outside the view."""
    gen = torch.Generator(device=dev).manual_seed(M)
    B, K, N, pitch = 2, 384, 51865, M * 51865 + 77
    x = torch.randint(-128, 128, (B, M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                      dtype=torch.int8)
    bias = torch.randint(-5000, 5000, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    sc = torch.rand((1,), generator=gen, device=dev) * 1e-4 + 1e-5
    arena = torch.zeros((B, pitch), dtype=torch.int8, device=dev)
    out = arena[:, 13:13 + M * N].view(B, M, N)
    ops.neutron_matmul_plan(x, w, bias, sc, "none", 0.05, 7, -128, 127, out)
    want = ops.neutron_matmul_plan(x, w, bias, sc, "none", 0.05, 7, -128,
                                   127, torch.empty_like(out), impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert not arena[:, :13].any() and not arena[:, 13 + M * N:].any()

    xf = _randn(gen, (B, M, K), torch.float32, dev)
    wt = _randn(gen, (N, K), torch.float32, dev) / math.sqrt(K)
    bf = _randn(gen, (N,), torch.float32, dev)
    buf = torch.zeros((B, pitch), dtype=torch.float32, device=dev)
    outf = buf[:, 13:13 + M * N].view(B, M, N)
    ops.neutron_matmul_nk(xf, wt, bf, "none", outf)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        wantf = ref.neutron_matmul_nk_ref(xf, wt, bf, "none")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(outf, wantf, atol=2e-3, rtol=1e-3)
    assert not buf[:, :13].any() and not buf[:, 13 + M * N:].any()


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_decode_step_at_full_width_matches_cpu(dev, precision):
    """One prefill and one decode step of the whisper-tiny decoder at full
    width (4 layers, d 384, 6 x 64, d_ff 1536, vocab 51865) on the card
    against the same compiled model on the CPU, fed the same inputs:
    float32 within float_plan_tol, int8 stored ints within one step; K1
    25, K2 4 and K3 4 launches."""
    import tempfile

    import repro_torch.api as tapi
    from repro_torch.core.executor import float_plan_tol
    from repro_torch.frontends import lm

    spec = lm.tiny_spec(scale=1, n_layers=4, vocab=51865)
    sess = tapi.DecodeSession(spec=spec, precision=precision, device=dev)
    cpu = tapi.DecodeSession(spec=spec, precision=precision, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        for key in ((8, 8), (1, 8)):
            cpu._models[key] = tapi.load(
                sess.model(*key).save(f"{d}/m.rpa"), device="cpu")
    outs = {}
    for s in (sess, cpu):
        run = s._run

        def capture(m, feed, s=s, run=run):
            outs[s] = (m, run(m, feed))
            return outs[s][1]
        s._run = capture
    prompt = [3, 17, 42, 5, 9, 1]
    n = (t_fa.launches, t_fd.launches, t_k1.launches)
    rid, tok = sess.prefill(prompt)
    prid, _ = cpu.prefill(prompt)
    checks = [dict(outs)]
    r, pr = sess._requests[rid], cpu._requests[prid]
    pr.caches = {k: v.cpu() for k, v in r.caches.items()}
    pr.tokens = list(r.tokens)
    sess.step(rid)
    cpu.step(prid)
    checks.append(dict(outs))
    assert (t_fa.launches - n[0], t_fd.launches - n[1],
            t_k1.launches - n[2]) == (4, 4, 50)
    for got in checks:
        m, want = got[cpu]
        card = got[sess][1]
        for name, w in want.items():
            g = card[name].cpu()
            assert torch.isfinite(g).all()
            if precision == "float32":
                assert float((g - w).abs().max()) <= float_plan_tol(
                    w.numpy()), name
            else:
                step = m.semantics._scale(name)
                assert float((g - w).abs().max()) <= 1.5 * step, name


# --------------------------------------------------------------------------
# whisper-tiny and qwen2-vl-2b (ROADMAP item 4): K2 not causal with
# Sq != Sk and no offset (the cross-attention), the encoder at S = 1500
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,Sk,D", [
    (4, 16, 16, 1, 1500, 64),       # whisper cross-attention, decode step
    (4, 16, 16, 16, 1500, 64),      # ... in forward, prompt 16
    (4, 16, 16, 1500, 1500, 64),    # whisper encoder
    (2, 6, 2, 1, 130, 128),         # one row, GQA, a 2-key tail
    (2, 4, 2, 5, 77, 32),
    (1, 2, 2, 3, 300, 64),
    (2, 4, 4, 129, 1500, 64),       # two query tiles, the second of one row
    (4, 16, 16, 288, 288, 128),     # qwen2-vl's prompt, not causal
])
def test_flash_attention_cross_matches_plain(dev, dtype, B, H, Hkv, S, Sk,
                                             D):
    """Not causal, Sq != Sk, no offset: every row sees all Sk keys; rows
    past S are never stored (a stray store would overwrite another head's
    rows, which differ here)."""
    gen = torch.Generator(device=dev).manual_seed(S + Sk + D)
    q = _randn(gen, (B, H, S, D), dtype, dev)
    k = _randn(gen, (B, Hkv, Sk, D), dtype, dev)
    v = _randn(gen, (B, Hkv, Sk, D), dtype, dev)
    n0 = t_fa.launches
    got = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention(q, k, v, causal=False, impl="ref")
    torch.cuda.synchronize()
    assert t_fa.launches == n0 + 1
    assert got.shape == (B, H, S, D)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def cross_tail_probe(B, H, Hkv, S, Sk, D, dtype, dev):
    """Inputs on which K2's key tail decides the output, not causal: q = 1
    and k = -4, so that every real key scores -4 sqrt(D) and a key read
    past Sk (zero-filled, score 0) would take nearly all the weight; v = 0
    but for markers at key 0 and at key Sk - 1.  Every output is
    (v[0] + v[Sk-1]) / Sk, about 1; a tail read one key too far gives
    about 0, the last key dropped about 0.5.  Returns (q, k, v, want)."""
    q = torch.ones((B, H, S, D), dtype=dtype, device=dev)
    k = torch.full((B, Hkv, Sk, D), -4.0, dtype=dtype, device=dev)
    v = torch.zeros((B, Hkv, Sk, D), dtype=dtype, device=dev)
    v[:, :, 0] = Sk / 2
    v[:, :, Sk - 1] = Sk / 2
    want = (v[:, :, 0].float() + v[:, :, Sk - 1].float()) / Sk
    want = want.repeat_interleave(H // Hkv, dim=1)[:, :, None]
    return q, k, v, want.expand(B, H, S, D)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Hkv,S,Sk,D", [
    (4, 16, 16, 1, 1500, 64), (4, 16, 16, 16, 1500, 64),
    (2, 6, 2, 1, 130, 128), (1, 4, 4, 3, 65, 16), (1, 4, 4, 1500, 1500, 64),
])
def test_flash_attention_cross_tail_probe(dev, dtype, B, H, Hkv, S, Sk, D):
    q, k, v, want = cross_tail_probe(B, H, Hkv, S, Sk, D, dtype, dev)
    got = ops.flash_attention(q, k, v, causal=False)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    torch.testing.assert_close(
        got.float(), ops.flash_attention(q, k, v, causal=False,
                                         impl="ref").float(),
        atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-2b"])
def test_encdec_and_vlm_on_the_card_match_cpu(dev, arch):
    """The reduced config, padded (3 heads over 1, to 4), in float32 on
    the card against the plain path on the CPU: forward, and the decode
    replay with its aux, within 2e-3; on the card the encoder, the
    cross-attention and the self-attention run K2 and K3 only."""
    import numpy as np

    from repro_torch.launch.serve import decode_aux, draw_inputs, generate
    from repro_torch.models import lm
    from repro_torch.models.registry import get_arch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_arch(arch).reduced(dtype="float32", n_heads=3,
                                     n_kv_heads=1, d_head=32, tp_pad=4)
        prompts, extra = draw_inputs(cfg, np.random.default_rng(0), 2, 12)
        batch = {"tokens": prompts, **extra}
        cpu = lm.init_params(cfg, 0, device="cpu")
        want = lm.forward(cfg, cpu, batch)
        want_gen = generate(cfg, cpu, prompts, 4,
                            aux=decode_aux(cfg, cpu, extra)[0])
        card = cpu.to(dev)
        n = (t_fa.launches, t_fd.launches)
        got = lm.forward(cfg, card, batch)
        fwd = (t_fa.launches - n[0], t_fd.launches - n[1])
        got_gen = generate(cfg, card, prompts, 4,
                           aux=decode_aux(cfg, card, extra)[0])
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    L = cfg.n_layers
    if cfg.enc_dec:     # encoder, self and cross in forward; then the
        #                 encoder once and a cross launch a layer a step
        assert fwd == (cfg.n_enc_layers + 2 * L, 0)
        assert (t_fa.launches - n[0], t_fd.launches - n[1]) == (
            2 * cfg.n_enc_layers + 2 * L + L * 16, L * 16)
    else:
        assert fwd == (L, 0)
        assert (t_fa.launches - n[0], t_fd.launches - n[1]) == (L, L * 16)
    torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(got_gen.prompt_logits.cpu(),
                               want_gen.prompt_logits, atol=2e-3, rtol=2e-3)
    assert (got_gen.tokens == want_gen.tokens).all()


# --------------------------------------------------------------------------
# the profiler, the process pool and the sticky-fault test (ROADMAP items
# 9 and 10)
# --------------------------------------------------------------------------


def test_profile_step_times_are_device_times(dev):
    """``profile()`` on the card: one measured step per plan step, the
    steps' CUDA-event times within the replay's; a device spin added to
    the first step (its host enqueue takes microseconds) shows in that
    step's time, so the times are the card's."""
    import numpy as np
    model = _session_models(dev, "int8")
    rep = model.profile(batch=4, runs=2)
    plan = model.plan_for(4)
    assert rep.measured["kernels"] == len(plan.steps)
    assert 0 < rep.measured["kernel_ms_per_request"] <= \
        rep.measured["wall_ms_per_request"]
    st = plan.steps[0]
    orig = st.run

    def spun(bufs, n):
        torch.cuda._sleep(4_000_000)        # 2 ms at 1.98 GHz
        orig(bufs, n)
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 8)).astype(
        np.float32)
    times = []
    st.run = spun
    try:
        t0 = time.monotonic()
        plan.run({model.graph.inputs[0].name: x}, n=4, step_times=times)
        host_s = time.monotonic() - t0
    finally:
        st.run = orig
    assert [lab for lab, _ in times] == [s.label for s in plan.steps]
    assert times[0][1] >= 1e-3
    assert sum(dt for _, dt in times) <= host_s


def test_process_pool_on_the_card_matches_the_thread_pool(dev, tmp_path):
    """``Session(workers=("process", 2))`` on the card: two children,
    each with its own CUDA context, serve the int8 model's artifact; every
    output equals the thread pool's and the plain path's on the CPU (the
    same artifact), and the children launched K1 once per conv and fc of
    each batch while the parent launched nothing."""
    import os

    import numpy as np
    import repro_torch.api as tapi

    path = _session_models(dev, "int8").save(str(tmp_path / "m.rpa"))
    cpu = tapi.load(path, device="cpu")
    convs = sum(op.kind in ("conv", "fc") for op in cpu.graph.ops)
    xs = np.random.default_rng(4).normal(size=(20, 16, 16, 8)).astype(
        np.float32)
    proc = tapi.Session(workers=("process", 2), max_batch=4,
                        heartbeat_timeout_s=5.0)
    thr = tapi.Session(workers=2, max_batch=4)
    try:
        proc.load(path, name="m")
        thr.load(path, name="m")
        children = [h for h in proc._pool.worker_health().values()
                    if h["ready"] and not h["abandoned"]]
        pids = {h["pid"] for h in children}
        assert len(pids) == 2 and os.getpid() not in pids
        assert {h["device"] for h in children} == {"cuda"}
        k0 = proc._pool.child_launches()["neutron_matmul"]
        n0 = t_k1.launches
        got = [t.result(timeout=120)
               for t in [proc.submit("m", x) for x in xs]]
        assert t_k1.launches == n0                  # the parent: nothing
        batches = proc.stats()["models"]["m"]["batches"]
        assert proc._pool.child_launches()["neutron_matmul"] - k0 == \
            convs * batches
        want = [t.result(timeout=120) for t in [thr.submit("m", x)
                                                for x in xs]]
        for i, (g, w) in enumerate(zip(got, want)):
            for k in w:
                assert g[k].device.type == "cpu"
                assert torch.equal(g[k], w[k]), (i, k)
                assert torch.equal(g[k], cpu.run_many([xs[i]])[0][k]), (i, k)
    finally:
        proc.close()
        thr.close()


def _device_fault_child(q):
    """In a process of its own: a launch the K1 launch function refuses
    (not sticky), then a device-side assert (sticky), each error put
    through ``procpool.device_context_lost``."""
    from repro_torch.kernels import _build
    from repro_torch.runtime.procpool import device_context_lost
    dev = torch.device("cuda")
    out = []
    fn = _build.function("neutron_matmul", "neutron_matmul_launch",
                         t_k1._ARGTYPES)
    s = torch.cuda.current_stream().cuda_stream
    try:
        rc = fn(*([None] * 5 + [0, 1, 1, 1] + [0, 1, 0, 0, 0, 1]
                  + [0] * 6 + [1.0] + [0] * 7 + [None, None, s]))
        _build.check(rc, "neutron_matmul")
        out.append(("no error", "", None))
    except Exception as e:
        out.append((type(e).__name__, str(e)[:200],
                    device_context_lost(e, torch.cuda.synchronize)))
    try:
        x = torch.zeros(4, device=dev)
        x[torch.tensor([10], device=dev)]
        torch.cuda.synchronize()
        out.append(("no error", "", None))
    except Exception as e:
        out.append((type(e).__name__, str(e)[:200],
                    device_context_lost(e, torch.cuda.synchronize)))
    q.put(out)


def test_device_context_lost_on_real_cuda_errors(dev):
    """The sticky-fault test on the card's own errors, in a spawned child
    (a device-side assert poisons its context): a refused launch is not
    sticky, the assert is."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_device_fault_child, args=(q,))
    p.start()
    try:
        got = q.get(timeout=300)
    finally:
        p.join(60)
        if p.is_alive():
            p.kill()
    (c1, m1, lost1), (c2, m2, lost2) = got
    assert lost1 is False and "CUDA error" in m1, got
    assert lost2 is True, got


# --------------------------------------------------------------------------
# Training: K2's log-sum-exp, K2b (the backward), the guard, checkpoints
# --------------------------------------------------------------------------

# the shapes of chip_smoke.py's K2b rows (minitron-4b's training shape with
# the kv expanded to the padded 32 heads, granite-20b's group of 48,
# gemma3's window, D 192 with Dv 128) and small float32 and ragged cases
BWD_CASES = [
    (8, 32, 32, 128, 128, 128, True, None, torch.bfloat16),
    (4, 48, 1, 100, 128, 128, True, None, torch.bfloat16),
    (1, 32, 16, 1040, 128, 128, True, 1024, torch.bfloat16),
    (2, 16, 16, 100, 192, 128, True, None, torch.bfloat16),
    (2, 6, 2, 77, 32, 24, True, None, torch.float32),
    (2, 6, 3, 70, 64, 32, True, 9, torch.float32),
    (1, 4, 2, 33, 16, 16, False, None, torch.float32),
    (1, 2, 1, 40, 256, 256, True, None, torch.float32),
    (2, 4, 2, 65, 80, 80, False, 20, torch.bfloat16),
]


def _bwd_inputs(dev, B, H, Hkv, S, D, Dv, causal, window, dtype, Sk=None):
    Sk = S if Sk is None else Sk
    gen = torch.Generator(device=dev).manual_seed(S + D + H)
    q = _randn(gen, (B, H, S, D), dtype, dev)
    k = _randn(gen, (B, Hkv, Sk, D), dtype, dev)
    v = _randn(gen, (B, Hkv, Sk, Dv), dtype, dev)
    do = _randn(gen, (B, H, S, Dv), dtype, dev)
    kx, vx = k.repeat_interleave(H // Hkv, 1), v.repeat_interleave(H // Hkv,
                                                                   1)
    o, lse = ref.flash_attention_fwd_lse_ref(q, kx, vx, causal=causal,
                                             window=window)
    return q, k, v, o, lse, do


def _held(got, want, dtype, what):
    """bf16: max|d| / max|plain| < 2e-2; float32: atol 2e-3 / rtol 1e-3."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    if dtype == torch.bfloat16:
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel < 2e-2, (what, rel)
    else:
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,causal,window,dtype", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(dev, B, H, Hkv, S, D, Dv,
                                                  causal, window, dtype):
    from repro_torch.kernels import flash_attention_bwd as t_fab
    q, k, v, o, lse, do = _bwd_inputs(dev, B, H, Hkv, S, D, Dv, causal,
                                      window, dtype)
    n0 = t_fab.launches
    got = t_fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    g = H // Hkv
    want = ref.flash_attention_bwd_ref(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), o, lse, do,
        causal=causal, window=window)
    torch.cuda.synchronize()
    assert t_fab.launches == n0 + 1
    # the plain version's dk, dv are per query head: sum over each group
    want = (want[0], want[1].float().reshape(B, Hkv, g, S, D).sum(2),
            want[2].float().reshape(B, Hkv, g, S, Dv).sum(2))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _held(a, b, dtype, name)
    again = t_fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    for a, b in zip(got, again):          # no atomics: the same bits
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D,Dv,causal,window", [
    (2, 6, 6, 100, 100, 64, 64, True, None),     # group 1, ragged S
    (2, 6, 1, 130, 130, 128, 128, True, None),   # group 6
    (1, 48, 1, 70, 70, 128, 128, True, None),    # group 48, G = 48
    (2, 4, 2, 100, 100, 192, 128, True, None),   # MLA's D 192 / Dv 128
    (1, 4, 4, 90, 90, 64, 128, False, None),     # D 64 / Dv 128
    (1, 2, 2, 65, 65, 192, 192, True, None),
    (1, 4, 2, 200, 200, 128, 128, True, 50),     # window
    (2, 4, 2, 50, 130, 128, 128, False, None),   # S != Sk
    (1, 4, 4, 70, 150, 64, 64, True, None),
    (1, 2, 1, 3, 3, 16, 16, True, None),       # row 0's dq is 0
    # whisper-tiny's training cross-attention: 128 decoder rows against
    # 1500 keys, a key tail of 28 past the 64-key tile
    (8, 16, 16, 128, 1500, 64, 64, False, None),
])
def test_flash_attention_bwd_mma_route(dev, B, H, Hkv, S, Sk, D, Dv, causal,
                                       window):
    """K2b's bf16 tensor-core route at tile edges (64), groups 1, 6 and 48
    (split over G slices), head dims 64 / 128 / 192 with Dv 128, causal,
    window and not, S != Sk: each gradient within max|d| / max|plain| <
    2e-2 of the plain version, and a rerun bit-equal."""
    from repro_torch.kernels import flash_attention_bwd as t_fab
    dtype = torch.bfloat16
    q, k, v, o, lse, do = _bwd_inputs(dev, B, H, Hkv, S, D, Dv, causal,
                                      window, dtype, Sk=Sk)
    g = H // Hkv
    plan = t_fab.bwd_plan(dtype, B, Hkv, Sk, g, D, Dv)
    assert plan.route == t_fab.MMA
    got = t_fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    want = ref.flash_attention_bwd_ref(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), o, lse, do,
        causal=causal, window=window)
    want = (want[0], want[1].float().reshape(B, Hkv, g, Sk, D).sum(2),
            want[2].float().reshape(B, Hkv, g, Sk, Dv).sum(2))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _held(a, b, dtype, name)
    again = t_fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_flash_attention_bwd_float32_stays_scalar(dev, monkeypatch):
    """float32 and head dims off the mma route take the scalar body; the
    C side refuses a route the call does not fit."""
    from repro_torch.kernels import flash_attention_bwd as t_fab
    assert t_fab.bwd_plan(torch.float32, 2, 2, 77, 3, 32, 24).route == \
        t_fab.SCALAR
    assert t_fab.bwd_plan(torch.bfloat16, 1, 2, 40, 1, 256, 256).route == \
        t_fab.SCALAR
    q, k, v, o, lse, do = _bwd_inputs(dev, 1, 2, 2, 40, 32, 24, True, None,
                                      torch.float32)
    monkeypatch.setattr(t_fab, "bwd_plan",
                        lambda *a: t_fab.BwdPlan(t_fab.MMA, 1))
    with pytest.raises(RuntimeError, match="invalid argument"):
        t_fab.flash_attention_bwd(q, k, v, o, lse, do)


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,causal,window,dtype",
                         BWD_CASES[:4] + BWD_CASES[5:7])
def test_flash_attention_lse_leaves_o_unchanged(dev, B, H, Hkv, S, D, Dv,
                                                causal, window, dtype):
    """K2 with return_lse writes the same o as without, and its lse
    matches the plain version's (bf16: within 1e-2, the bf16 rounding of
    P moves each row sum by at most 2^-8 of itself)."""
    q, k, v, _, _, _ = _bwd_inputs(dev, B, H, Hkv, S, D, Dv, causal, window,
                                   dtype)
    o0 = ops.flash_attention(q, k, v, causal=causal, window=window)
    o1, lse = t_fa.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    assert torch.equal(o0, o1)
    g = H // Hkv
    _, want = ref.flash_attention_fwd_lse_ref(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
        causal=causal, window=window)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(lse, want, atol=tol, rtol=0)


def test_flash_attention_fn_on_the_card_matches_the_cpu(dev):
    """ops.flash_attention under grad on CUDA (K2 with lse, then K2b) and
    on the CPU (the plain versions) from the same float32 inputs."""
    from repro_torch.kernels import flash_attention_bwd as t_fab
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=gen) for s in
               ((2, 6, 50, 32), (2, 2, 50, 32), (2, 2, 50, 16)))
    do = torch.randn(2, 6, 50, 16, generator=gen)
    grads = []
    for d in ("cpu", dev):
        ts = [t.detach().to(d).requires_grad_(True) for t in (q, k, v)]
        o = ops.flash_attention(*ts, causal=True, window=20)
        n0 = t_fab.launches
        o.backward(do.to(d))
        if d != "cpu":
            assert t_fab.launches == n0 + 1
        grads.append([o.detach().cpu()] + [t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=2e-3, rtol=1e-3)


def test_kernels_without_backward_raise_under_grad_on_the_card(dev):
    x = torch.zeros(4, 8, device=dev, requires_grad=True)
    calls = [
        lambda: ops.neutron_matmul(x, torch.zeros(8, 3, device=dev)),
        lambda: ops.flash_decode(x.reshape(1, 4, 8),
                                 torch.zeros(1, 4, 5, 8, device=dev),
                                 torch.zeros(1, 4, 5, 8, device=dev)),
    ]
    counts = (t_k1.launches, t_fd.launches)
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward kernel"):
            call()
    assert (t_k1.launches, t_fd.launches) == counts


def test_ssd_scan_takes_a_grad_on_the_card(dev):
    """K4 has a backward: a tensor requiring grad reaching ops.ssd_scan
    runs K4, and its backward K4b, once each; under no_grad no graph is
    built."""
    from repro_torch.kernels import ssd_scan_bwd as t_ssdb
    x = torch.ones(1, 4, 1, 8, device=dev, requires_grad=True)
    args = (torch.ones(1, 4, 1, device=dev), -torch.ones(1, device=dev),
            torch.ones(1, 4, 2, device=dev), torch.ones(1, 4, 2, device=dev))
    n0 = (t_ssd.launches, t_ssdb.launches)
    y, _ = ops.ssd_scan(x, *args, chunk=4)
    y.sum().backward()
    torch.cuda.synchronize()
    assert (t_ssd.launches, t_ssdb.launches) == (n0[0] + 1, n0[1] + 1)
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with torch.no_grad():
        y, _ = ops.ssd_scan(x, *args, chunk=4)
    assert y.grad_fn is None
    assert t_ssdb.launches == n0[1] + 1


def test_save_async_of_a_cuda_state_while_the_next_step_runs(dev, tmp_path):
    """A checkpoint of a training state on the card taken with save_async
    holds the values of its step, though the next step updates the
    parameters in place while the file is written."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import train as ttrain
    from repro_torch.models.convert import (train_state_from_numpy,
                                            train_state_to_host)
    from repro_torch.models.registry import get_arch
    cfg = get_arch("minitron-4b").reduced(dtype="float32")
    state = ttrain.init_train_state(cfg, 0, dev)
    step = ttrain.make_train_step(cfg)
    dcfg = DataConfig(cfg.vocab, 32, 4)
    state, _ = step(state, batch_for_step(dcfg, 0))
    want = train_state_to_host(cfg, state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, train_state_to_host(cfg, state), copy=False)
    state, _ = step(state, batch_for_step(dcfg, 1))
    mgr.wait()
    tree, s, _ = mgr.restore(want)
    assert s == 1
    back = train_state_from_numpy(cfg, tree, dev)
    got = train_state_to_host(cfg, back)
    flat = lambda t: [t.params, t.opt.m, t.opt.v]      # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        for key in a:
            _equal_trees(a[key], b[key])
    assert int(got.opt.step) == 1


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# distribution on the card: two ranks share the one card over gloo
# --------------------------------------------------------------------------


DIST_CARD_ARCHS = ("granite-moe-1b-a400m", "mamba2-370m", "deepseek-v3-671b",
                   "gemma3-27b")


def _dist_card_rank(rank, world, store, out_dir):
    """One rank (a spawned process on cuda:0) of the card's distribution
    checks: moe_a2a on the card against the CPU, the sequence-sharded
    decode against one rank's, and two steps of reduced granite-moe's
    sharded train step on the card against the CPU."""
    import os
    import pickle
    import traceback

    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = {}
    try:
        from repro_torch.data.pipeline import DataConfig, batch_for_step
        from repro_torch.launch.mesh import make_mesh, use_mesh
        from repro_torch.models import attention, lm, sharding, train
        from repro_torch.models.convert import (train_state_from_numpy,
                                                train_state_to_host)
        from repro_torch.models.moe import MoE, init_moe, moe_a2a
        from repro_torch.models.registry import get_arch
        mesh = make_mesh(1, world, device="cuda")
        gen = torch.Generator().manual_seed(0)
        cfg = get_arch("granite-moe-1b-a400m").reduced(dtype="float32")
        p = init_moe(gen, MoE(cfg, torch.float32, "cpu"))
        x = torch.randn(2, 8, cfg.d_model, generator=gen)
        with use_mesh(mesh), torch.no_grad():
            out = {}
            for d in ("cuda", "cpu"):
                q = p.to(d)
                for w in (q.experts.w_in, q.experts.w_gate, q.experts.w_out):
                    sharding.shard_tensor(w, ("model", None, None))
                out[d] = moe_a2a(q, x.to(d), cfg).cpu()
                p = init_moe(torch.Generator().manual_seed(0),
                             MoE(cfg, torch.float32, "cpu"))
            res["moe"] = float((out["cuda"] - out["cpu"]).abs().max())
            # decode: granite-20b reduced in bf16, one kv head
            c2 = get_arch("granite-20b").reduced()
            layer = lm.DecoderLayer(c2, torch.bfloat16, "cuda")
            lm._init_decoder_layer(torch.Generator(device="cuda")
                                   .manual_seed(1), layer)
            B, S = 2, 16
            g2 = torch.Generator(device="cuda").manual_seed(2)
            ck, cv = (torch.randn(B, 1, S, c2.head_dim, generator=g2,
                                  device="cuda").bfloat16()
                      for _ in range(2))
            xs = [torch.randn(B, 1, c2.d_model, generator=g2,
                              device="cuda").bfloat16() for _ in range(2)]
            res["seq"] = attention._use_seq_sharded_decode(c2, B, S)
            half = slice(rank * S // 2, (rank + 1) * S // 2)
            kl, vl = ck[:, :, half].clone(), cv[:, :, half].clone()
            from repro_torch.kernels import flash_decode
            flash_decode.lse_launches = 0
            got = [lm._decoder_layer(layer, xx, c2,
                                     torch.full((B, 1), pos, device="cuda"),
                                     kv_cache=(kl, vl), cache_pos=pos)[0]
                   for xx, pos in zip(xs, (7, 8))]
            res["lse_launches"] = flash_decode.lse_launches
        with torch.no_grad():
            want = [lm._decoder_layer(layer, xx, c2,
                                      torch.full((B, 1), pos, device="cuda"),
                                      kv_cache=(ck, cv), cache_pos=pos)[0]
                    for xx, pos in zip(xs, (7, 8))]
        res["decode"] = max(float((g.float() - w.float()).abs().max()
                                  / w.float().abs().max())
                            for g, w in zip(got, want))
        # two sharded train steps on the card against the CPU, then
        # three decode steps on the caches init_cache lays out on the mesh
        # (kv heads, SSD heads and conv channels split, the MLA latent
        # whole)
        for arch in DIST_CARD_ARCHS:
            c = get_arch(arch).reduced(dtype="float32")
            host = train_state_to_host(c, train.init_train_state(c, 0,
                                                                 "cpu"))
            step = train.make_train_step(c)
            dcfg = DataConfig(c.vocab, 16, 4)
            ms, lg = {}, {}
            toks = torch.randint(0, c.vocab, (4, 3),
                                 generator=torch.Generator().manual_seed(3))
            with use_mesh(mesh):
                for d in ("cuda", "cpu"):
                    state = train_state_from_numpy(c, host, d)
                    ms[d] = []
                    for i in range(2):
                        state, m = step(state, batch_for_step(dcfg, i))
                        ms[d].append(float(m["loss"]))
                    with torch.no_grad():
                        cache = lm.init_cache(c, 4, 3, device=d)
                        lg[d] = [lm.decode_step(c, state.params, cache,
                                                toks[:, t], t)[0].cpu()
                                 for t in range(3)]
            res[("train", arch)] = ms
            res[("decode", arch)] = max(
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(lg["cuda"], lg["cpu"]))
    except BaseException:
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.destroy_process_group()


def test_distribution_on_the_card_matches_the_cpu(dev, tmp_path):
    """Two gloo ranks on the one card, mesh (1, 2): moe_a2a with the
    experts split (card vs CPU within 1e-4), granite-20b's decode against
    a cache split by positions (within 2e-2 of one rank's, K3 with the
    lse twice on each rank), and for reduced granite-moe, mamba2,
    deepseek-v3 and gemma3 in float32 (each layer on this rank's heads or
    experts: K2, K2b, K3, K4, K4b on the shards) two sharded train steps
    (losses card vs CPU within 2e-4 relative, equal on both ranks) and
    three decode steps (logits card vs CPU within 1e-4 of their max)."""
    import pickle

    import torch.multiprocessing as mp
    mp.spawn(_dist_card_rank, args=(2, str(tmp_path / "store"),
                                    str(tmp_path)), nprocs=2)
    res = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    for r, x in enumerate(res):
        assert "error" not in x, x.get("error")
        assert x["moe"] < 1e-4, (r, x["moe"])
        assert x["seq"] and x["lse_launches"] == 2
        assert x["decode"] < 2e-2, (r, x["decode"])
        for arch in DIST_CARD_ARCHS:
            got = x[("train", arch)]
            for a, c in zip(got["cuda"], got["cpu"]):
                assert abs(a - c) <= 2e-4 * abs(c), (r, arch, got)
            assert x[("decode", arch)] < 1e-4, (r, arch, x[("decode", arch)])
    for arch in DIST_CARD_ARCHS:
        assert res[0][("train", arch)] == res[1][("train", arch)]
