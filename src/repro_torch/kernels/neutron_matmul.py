"""Output-stationary fused matmul (K1) on the H100.

Launch wrapper of the hand-written CUDA kernel ``csrc/neutron_matmul.cu``,
which replaces the Pallas kernel of ``repro/kernels/neutron_matmul.py``.
One int8 (or f32/bf16) GEMM body with two epilogues:

  * :func:`neutron_matmul`, the Pallas kernel's contract:
    ``y = requant(act(scale * (x @ w) + bias))`` on x (M,K), w (K,N);
  * :func:`neutron_matmul_plan`, the int8 plan replay's contract:
    ``q = clip(rint(act(f32(acc + bias) * sc) / s_out) + zp_out)`` with
    strided, batched operands, so a conv reads its input slot of the
    arena and writes its output slot in place;
  * :func:`neutron_matmul_nk`, the Pallas contract in float32 as the
    float32 plan calls it: ``act(x @ w + bias)`` with the weight given
    as the (N, K) matrix the plan stores once at lowering, and strided,
    batched operands written in place, as in the plan contract.

Their plain PyTorch versions are ``ref.neutron_matmul_ref``,
``ref.neutron_matmul_plan_ref`` and ``ref.neutron_matmul_nk_ref``;
``ops`` chooses between kernel and plain version by the device of the
inputs.

The int8 body runs on the tensor cores; its load width, span mode and
k-split come from :func:`plan`, a pure function of the shapes, strides
and base addresses.  The float32 and bfloat16 inputs take one of two
routes from :func:`float_plan`, likewise pure: a GEMV for at most
SKINNY_MAX_ROWS rows over batch * M (a decode step, the fc), and 3xTF32
products on the tensor cores for more.  A split's partial tiles (int32
for the int8 body, float32 for the float one) and its tickets are kept
per (device, stream).

``launches`` counts the kernel launches of this process (every
contract), ``launches_by_contract`` the same launches by
``contract_key``.
"""
from __future__ import annotations

import ctypes
import threading
from collections import Counter
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build
from .ref import IR_ACTIVATIONS

launches = 0
launches_by_contract: Counter = Counter()
# guards the counters and the scratch dict: serving workers launch from
# several threads
_lock = threading.Lock()

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 7
             + [ctypes.c_void_p] * 3)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PALLAS, _PLAN = 0, 1
_ACT_CODES = {a: i for i, a in enumerate(IR_ACTIVATIONS)}

SMS = 132                 # streaming multiprocessors of an H100 SXM
TILE = 64                 # the int8 body's output tile is TILE x TILE
RING_BK = 64              # bytes of K per stage of its cp.async ring
SPAN_MAX_K = 160          # span mode takes the whole K in one tile
MIN_SPLIT_KTILES = 2      # no k-split gets fewer k-tiles than this
SPAN = 0                  # the load mode of span mode

# the float bodies
SKINNY, TILED = 0, 1      # their routes
SKINNY_MAX_ROWS = 16      # the skinny route takes batch * M up to this
SKINNY_WARPS = 8          # warps of a skinny block
SKINNY_COLS = 2           # output columns a skinny warp owns
SKINNY_MIN_K = 256        # elements of K each splitting warp keeps
F_TILE_M = 64             # the tiled route's output tile is 64 x tile_n
F_BK = 32                 # elements of K per staged k-tile


class K1Plan(NamedTuple):
    """How the int8 body runs one call: ``load`` is the width of its
    staging copies in bytes (16, 8, 4; 1 for plain byte loads) or SPAN,
    and the grid is (row_tiles, col_tiles, splits)."""
    load: int
    row_tiles: int
    col_tiles: int
    splits: int


def load_width(K: int, strides: Tuple[int, ...], ptrs: Tuple[int, ...]
               ) -> int:
    """The widest copy, 16, 8 or 4 bytes, that divides K, every stride
    (in bytes) and every base address; 1 where none does."""
    bits = K
    for v in (*strides, *ptrs):
        bits |= v
    for w in (16, 8, 4):
        if bits % w == 0:
            return w
    return 1


def rows_contiguous(batch: int, M: int, K: int, x_bstride: int, x_ow: int,
                    x_sy: int, x_sx: int) -> bool:
    """Whether row r of x (over batch * M) starts at r * K: one tile of
    rows is then one contiguous span."""
    return (x_sx == K and (x_ow >= M or x_sy == x_ow * K)
            and (batch == 1 or x_bstride == M * K))


def num_splits(tiles: int, K: int, k_tile: int = RING_BK) -> int:
    """How many k-ranges each output tile is split into: enough that
    ``tiles * splits`` blocks fill the SMS SMs, as far as every range
    keeps MIN_SPLIT_KTILES k-tiles of ``k_tile`` elements (the int8
    ring's RING_BK bytes, the tiled float route's F_BK); at least 1."""
    if tiles >= SMS:
        return 1
    k_tiles = -(-K // k_tile)
    return max(1, min(-(-SMS // tiles), k_tiles // MIN_SPLIT_KTILES))


def plan(batch: int, M: int, N: int, K: int, x_bstride: int, x_ow: int,
         x_sy: int, x_sx: int, x_ptr: int, w_ptr: int) -> K1Plan:
    """The int8 body's plan for x rows (batch * M of K bytes, strides in
    bytes) and w (N, K) at the given base addresses.  Span mode where the
    rows are contiguous, K is at most SPAN_MAX_K and 16-byte copies of
    rows are not possible; else the ring at ``load_width``, split along K
    where the tile grid leaves SMs idle."""
    row_tiles, col_tiles = -(-batch * M // TILE), -(-N // TILE)
    load = load_width(K, (x_bstride, x_sy, x_sx), (x_ptr, w_ptr))
    if load < 16 and K <= SPAN_MAX_K and rows_contiguous(
            batch, M, K, x_bstride, x_ow, x_sy, x_sx):
        return K1Plan(SPAN, row_tiles, col_tiles, 1)
    return K1Plan(load, row_tiles, col_tiles,
                  num_splits(row_tiles * col_tiles, K))


class FloatPlan(NamedTuple):
    """How a float32 or bfloat16 call runs.  ``route`` SKINNY: grid
    ceil(N / tile_n) blocks of SKINNY_WARPS warps, each owning
    SKINNY_COLS columns, ``splits`` warps of a column pair splitting K
    (so ``tile_n`` = SKINNY_COLS * SKINNY_WARPS / splits columns a
    block).  ``route`` TILED: grid (ceil(R / 64), ceil(N / tile_n),
    splits), K split over blocks.  ``load``: 16-byte loads, or one
    element (its size in bytes) a load."""
    route: int
    tile_n: int
    load: int
    splits: int


def skinny_k_warps(N: int, K: int) -> int:
    """Warps of a skinny block that split K (1, 2, 4 or 8): doubled while
    the grid has fewer than 2 * SMS blocks and each warp keeps at least
    SKINNY_MIN_K elements of K."""
    kw = 1
    while (kw < SKINNY_WARPS
           and -(-N // (SKINNY_COLS * SKINNY_WARPS // kw)) < 2 * SMS
           and K // (2 * kw) >= SKINNY_MIN_K):
        kw *= 2
    return kw


def float_plan(batch: int, M: int, N: int, K: int,
               strides: Tuple[int, int, int], ptrs: Tuple[int, int],
               elem: int = 4) -> FloatPlan:
    """The float bodies' plan for x rows (batch * M of K elements of
    ``elem`` bytes; ``strides`` = (batch, row, column) strides of x in
    elements) and w (N, K) at the base addresses ``ptrs`` (x, w).  The
    route depends on batch * M alone: SKINNY up to SKINNY_MAX_ROWS rows,
    else TILED with a tile of 32 columns where N <= 32 (else 64), split
    along K where the tiles leave SMs idle.  Loads are 16 bytes where K,
    the strides and the addresses allow, else one element."""
    R = batch * M
    wide = load_width(K * elem, tuple(v * elem for v in strides),
                      ptrs) == 16
    load = 16 if wide else elem
    if R <= SKINNY_MAX_ROWS:
        kw = skinny_k_warps(N, K)
        return FloatPlan(SKINNY, SKINNY_COLS * SKINNY_WARPS // kw, load, kw)
    tile_n = 32 if N <= 32 else 64
    tiles = -(-R // F_TILE_M) * -(-N // tile_n)
    return FloatPlan(TILED, tile_n, load, num_splits(tiles, K, F_BK))


# Per (device index, stream handle, dtype of the partials): the partial
# tiles of split calls and their tickets, which the kernel leaves at 0.
_scratch: Dict[Tuple[int, int, torch.dtype],
               Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch_for(dev: torch.device, stream: int, tiles: int, n_part: int,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split scratch of (device, stream): ``n_part`` partials of
    ``dtype`` and ``tiles`` tickets, zeroed when allocated.  The kernel
    resets the tickets and the int8 body's int32 sums to 0 after each
    use; the float body writes its partials before it reads them."""
    key = (dev.index, stream, dtype)
    with _lock:
        part, tickets = _scratch.get(key, (None, None))
        if part is None or part.numel() < n_part:
            part = torch.zeros(n_part, dtype=dtype, device=dev)
        if tickets is None or tickets.numel() < tiles:
            tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
        _scratch[key] = (part, tickets)
    return part, tickets


def contract_key(contract: int, dtype: torch.dtype) -> str:
    """What ``launches_by_contract`` counts a launch under: the contract
    and the operands' dtype, e.g. ``"plan int8"`` or ``"pallas
    float32"``."""
    return (f"{'plan' if contract == _PLAN else 'pallas'} "
            f"{str(dtype).removeprefix('torch.')}")


def _act_code(act: Optional[str]) -> int:
    act = "none" if act is None else act
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    return _ACT_CODES[act]


def _rows(x: torch.Tensor):
    """(batch, M, K, batch stride, x_ow, x_sy, x_sx) of an operand of
    shape (batch, M, K) or (batch, R, C, K) with unit stride along K."""
    if x.dim() == 3:
        B, M, K = x.shape
        return B, M, K, x.stride(0), max(M, 1), 0, x.stride(1)
    if x.dim() == 4:
        B, R, C, K = x.shape
        return B, R * C, K, x.stride(0), max(C, 1), x.stride(1), x.stride(2)
    raise ValueError(f"x must be (batch, M, K) or (batch, R, C, K); got "
                     f"{tuple(x.shape)}")


def _launch(x, w, scale, bias, y, rows, N, ldy, y_bstride, out_code,
            contract, act, scale_per_col, requant, out_scale, out_zp,
            qmin, qmax) -> None:
    global launches
    B, M, K, xb, x_ow, x_sy, x_sx = rows
    stream = _build.stream_of(x)
    route, tile_n, part, tickets = 0, TILE, None, None
    if B * M > 1 << 30 or -(-N // TILE) > 65535:
        raise ValueError(f"neutron_matmul: batch * M = {B * M}, N={N} "
                         f"exceed the kernel's grid")
    if x.dtype == torch.int8:
        pl = plan(B, M, N, K, xb, x_ow, x_sy, x_sx, x.data_ptr(),
                  w.data_ptr())
        load, splits = pl.load, pl.splits
        if splits > 1:
            tiles = pl.row_tiles * pl.col_tiles
            part, tickets = _scratch_for(x.device, stream, tiles,
                                         tiles * TILE * TILE, torch.int32)
    else:
        fp = float_plan(B, M, N, K, (xb, x_sy, x_sx),
                        (x.data_ptr(), w.data_ptr()), x.element_size())
        route, tile_n, load, splits = fp
        if route == TILED and splits > 1:
            tiles = -(-B * M // F_TILE_M) * -(-N // tile_n)
            part, tickets = _scratch_for(
                x.device, stream, tiles, tiles * splits * F_TILE_M * tile_n,
                torch.float32)
    fn = _build.function("neutron_matmul", "neutron_matmul_launch",
                         _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(),
                scale.data_ptr() if scale is not None else None,
                bias.data_ptr() if bias is not None else None,
                y.data_ptr(), B, M, N, K, xb, x_ow, x_sy, x_sx, y_bstride,
                ldy, _CODES[x.dtype], out_code, contract, act,
                scale_per_col, requant, out_scale, out_zp, qmin, qmax,
                load, splits, route, tile_n,
                part.data_ptr() if part is not None else None,
                tickets.data_ptr() if tickets is not None else None,
                stream)
    _build.check(rc, "neutron_matmul")
    with _lock:
        launches += 1
        launches_by_contract[contract_key(contract, x.dtype)] += 1


def _check_cuda(*ts) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t is not None and t.device != dev
                                 for t in ts):
        raise ValueError("neutron_matmul's kernel takes CUDA tensors on one "
                         "device")


def neutron_matmul(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, scale=None,
                   act: str = "none", out_dtype: Optional[torch.dtype] = None,
                   out_scale: Optional[float] = None,
                   **block_kw) -> torch.Tensor:
    """The Pallas contract: ``y[M,N] = requant(act(scale * (x @ w) +
    bias))`` for x (M,K), w (K,N) of one dtype (int8: int32 accumulation;
    float32/bfloat16: f32).  ``scale`` is a number or (N,); ``bias`` (N,);
    ``out_scale`` requantizes to int8.  Block sizes (``block_kw``) are
    accepted for the JAX API and ignored: the kernel's tile is fixed.
    Launches on the current stream and never synchronises."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x (M,K) and w (K,N) do not match: "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in _CODES or w.dtype != x.dtype:
        raise TypeError(f"neutron_matmul takes int8, float32 or bfloat16 x "
                        f"and w of one dtype; got {x.dtype}, {w.dtype}")
    M, K = x.shape
    N = w.shape[1]
    if min(M, K, N) < 1:
        raise ValueError(f"empty operand: {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    _check_cuda(x, w, bias)
    dev = x.device
    requant = out_scale is not None
    if out_dtype is None:
        out_dtype = torch.int8 if requant else (
            torch.float32 if x.dtype == torch.int8 else x.dtype)
    if out_dtype not in _CODES or (requant and out_dtype != torch.int8):
        raise TypeError(f"out_dtype {out_dtype} is not one the kernel "
                        f"writes")
    sc = None
    if scale is not None:
        sc = torch.as_tensor(scale, dtype=torch.float32).to(dev).reshape(-1)
        if sc.numel() not in (1, N):
            raise ValueError(f"scale must be a number or ({N},); got "
                             f"{tuple(sc.shape)}")
        sc = sc.contiguous()
    b = None
    if bias is not None:
        b = bias.to(dev, torch.float32).reshape(-1).contiguous()
        if b.numel() != N:
            raise ValueError(f"bias must be ({N},); got {tuple(bias.shape)}")
    x = x.contiguous()
    wt = w.t().contiguous()                 # (N, K), the kernel's layout
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    _launch(x[None], wt, sc, b, y, _rows(x[None]), N, N, M * N,
            _CODES[out_dtype], _PALLAS, _act_code(act),
            int(sc is not None and sc.numel() > 1), int(requant),
            float(out_scale) if requant else 1.0, 0, -128, 127)
    return y


def neutron_matmul_plan(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor], sc: torch.Tensor,
                        act: str, out_scale: float, out_zp: int, qmin: int,
                        qmax: int, out: torch.Tensor) -> torch.Tensor:
    """The plan contract, written into ``out`` in place:
    ``out[b,m,n] = clip(rint(act(f32(sum_k x[b,m,k] w[n,k] + bias[n]) *
    sc[n]) / out_scale) + out_zp, qmin, qmax)``.

    x int8 (batch, M, K) or (batch, R, C, K) (M = R*C rows, e.g. a
    strided view of an arena slot), unit stride along K; w int8 (N, K)
    contiguous; bias int32 (N,) or None; sc float32 (N,) or (1,); out
    int8 (batch, M, N) with unit stride along N and rows at a uniform
    pitch (any batch stride).  The caller guarantees that the int32
    accumulators cannot overflow."""
    rows = _rows(x)
    B, M, K = rows[:3]
    if x.dtype != torch.int8 or w.dtype != torch.int8 or \
            out.dtype != torch.int8:
        raise TypeError(f"the plan contract takes int8 x, w and out; got "
                        f"{x.dtype}, {w.dtype}, {out.dtype}")
    N = w.shape[0]
    if w.shape != (N, K) or not w.is_contiguous():
        raise ValueError(f"w must be contiguous ({N}, {K}); got "
                         f"{tuple(w.shape)}")
    if x.stride(-1) != 1 or out.stride(-1) != 1:
        raise ValueError("x and out need unit stride along their last axis")
    if out.dim() != 3 or tuple(out.shape) != (B, M, N):
        raise ValueError(f"out must be ({B}, {M}, {N}); got "
                         f"{tuple(out.shape)}")
    if sc.dtype != torch.float32 or sc.numel() not in (1, N) or \
            not sc.is_contiguous():
        raise TypeError(f"sc must be contiguous float32 (1,) or ({N},)")
    if bias is not None and (bias.dtype != torch.int32
                             or bias.shape != (N,)
                             or not bias.is_contiguous()):
        raise TypeError(f"bias must be contiguous int32 ({N},)")
    if min(B, M, K, N) < 1:
        raise ValueError("empty operand")
    _check_cuda(x, w, sc, bias, out)
    _launch(x, w, sc, bias, out, rows, N, out.stride(1), out.stride(0),
            _CODES[torch.int8], _PLAN, _act_code(act), int(sc.numel() > 1),
            1, float(out_scale), int(out_zp), int(qmin), int(qmax))
    return out


def neutron_matmul_nk(x: torch.Tensor, wt: torch.Tensor,
                      bias: Optional[torch.Tensor], act: str,
                      out: torch.Tensor) -> torch.Tensor:
    """The Pallas contract in float32 with an (N, K) weight, written into
    ``out`` in place: ``out[b,m,n] = act(sum_k x[b,m,k] wt[n,k] +
    bias[n])``, accumulated in f32: on FMAs up to SKINNY_MAX_ROWS rows
    over batch * M, above that on the tensor cores in 3xTF32 (split
    hi/lo operands, three TF32 products each), never in plain TF32.

    x float32 (batch, M, K) or (batch, R, C, K) (M = R*C rows, e.g. a
    strided view of an arena slot), unit stride along K; wt float32 (N, K)
    contiguous; bias float32 (N,) or None; out float32 (batch, M, N) with
    unit stride along N and rows at a uniform pitch (any batch stride).
    ``act`` is one of the IR's activations."""
    rows = _rows(x)
    B, M, K = rows[:3]
    f32 = torch.float32
    if x.dtype != f32 or wt.dtype != f32 or out.dtype != f32:
        raise TypeError(f"neutron_matmul_nk takes float32 x, wt and out; "
                        f"got {x.dtype}, {wt.dtype}, {out.dtype}")
    N = wt.shape[0]
    if wt.shape != (N, K) or not wt.is_contiguous():
        raise ValueError(f"wt must be contiguous ({N}, {K}); got "
                         f"{tuple(wt.shape)}")
    if x.stride(-1) != 1 or out.stride(-1) != 1:
        raise ValueError("x and out need unit stride along their last axis")
    if out.dim() != 3 or tuple(out.shape) != (B, M, N):
        raise ValueError(f"out must be ({B}, {M}, {N}); got "
                         f"{tuple(out.shape)}")
    if bias is not None and (bias.dtype != f32 or bias.shape != (N,)
                             or not bias.is_contiguous()):
        raise TypeError(f"bias must be contiguous float32 ({N},)")
    if min(B, M, K, N) < 1:
        raise ValueError("empty operand")
    _check_cuda(x, wt, bias, out)
    _launch(x, wt, None, bias, out, rows, N, out.stride(1), out.stride(0),
            _CODES[f32], _PALLAS, _act_code(act), 0, 0, 1.0, 0, -128, 127)
    return out
