"""The port's CUDA kernels on the card against their plain PyTorch
versions.  Needs an NVIDIA GPU (H100, sm_90a) and nvcc: skipped
elsewhere.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only PyTorch is installed.
Tolerances: float32 atol 2e-3 / rtol 1e-3 (those of tests/test_kernels.py);
bfloat16 atol/rtol 2e-2, since both sides round the output to bf16.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import flash_decode as t_fd
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
    (2, 4, 4, 48, 24, 16, False, None, torch.bfloat16),
])
def test_flash_attention_kernel_matches_plain(dev, B, H, Hkv, S, D, Dv,
                                              causal, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(S + D)
    q = _randn(gen, (B, H, S, D), dtype, dev)
    k = _randn(gen, (B, Hkv, S, D), dtype, dev)
    v = _randn(gen, (B, Hkv, S, Dv), dtype, dev)
    n0 = t_fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl="ref")
    torch.cuda.synchronize()
    assert t_fa.launches == n0 + 1
    assert got.shape == (B, H, S, Dv) and got.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,lens,dtype", [
    (4, 24, 8, 116, 128, 128, (116, 116, 116, 116), torch.bfloat16),
    (4, 24, 8, 116, 128, 128, (1, 50, 100, 116), torch.bfloat16),
    (4, 32, 32, 216, 80, 80, (216, 216, 216, 216), torch.bfloat16),  # zamba2
    (2, 4, 4, 150, 80, 80, (150, 3), torch.float32),
    (3, 4, 2, 300, 32, 32, (1, 129, 300), torch.float32),
    (2, 4, 2, 64, 24, 16, (40, 9), torch.float32),
    (2, 8, 1, 513, 256, 256, (513, 257), torch.float32),
])
def test_flash_decode_kernel_matches_plain(dev, B, H, Hkv, S, D, Dv, lens,
                                           dtype):
    gen = torch.Generator(device=dev).manual_seed(S + D)
    q = _randn(gen, (B, H, D), dtype, dev)
    k = _randn(gen, (B, Hkv, S, D), dtype, dev)
    v = _randn(gen, (B, Hkv, S, Dv), dtype, dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = t_fd.launches
    got, lse = ops.flash_decode(q, k, v, kv_len=kv_len, return_lse=True)
    want, want_lse = ops.flash_decode(q, k, v, kv_len=kv_len,
                                      return_lse=True, impl="ref")
    torch.cuda.synchronize()
    assert t_fd.launches == n0 + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=1e-3)


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
