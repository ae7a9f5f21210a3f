"""The work of each kernel of the port: its operations, by the rate the
card has for their operands, and the bytes it must move.

One set of formulas for every place that counts a kernel's work: the
meta branch of ``ops`` (``kernels/meta.py``), which reports each call to
the dry run's cost counter (``analysis/cost.py``), and ``chip_smoke.py``'s
kernel table, whose ``bound_ms`` column is ``analysis.roofline.bound`` of
these counts.  Operations are given as {rate: count}, the rate one of the
keys of ``analysis.roofline.PEAK_FLOPS``; bytes are each operand read
once and each output written once (``nbytes``).

Where the work depends on the data, the count is what the inputs' shapes
give: K2 with a query offset counts every (query, key) pair, and K3
every position of the cache it is given (its
``kv_len`` lies on the device; a decode step at the cache's last
position, as the dry run's, reads all of them).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

#: the rate a kernel's products run at, by the dtype of their operands
RATES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
         torch.int8: "int8", torch.float16: "bfloat16"}


def rate_of(dtype: torch.dtype) -> str:
    return RATES[dtype]


def nbytes(*ts) -> int:
    """Bytes of the tensors given (None skipped), each counted once."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def causal_pairs(S: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal attention over S positions scores, each
    query seeing at most `window` keys (itself included)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_pairs(B: int, H: int, S: int, Sk: int, causal: bool,
                    window: Optional[int]) -> int:
    """(query, key) pairs K2 scores over B x H heads: the causal ones
    (``causal_pairs``), or every one of S x Sk."""
    return B * H * (causal_pairs(S, window) if causal else S * Sk)


def flash_attention_flops(B: int, H: int, S: int, Sk: int, D: int, Dv: int,
                          causal: bool, window: Optional[int]) -> int:
    """K2: q.k over D and p.v over Dv for every scored pair."""
    return 2 * attention_pairs(B, H, S, Sk, causal, window) * (D + Dv)


def flash_attention_bwd_flops(B: int, H: int, S: int, Sk: int, D: int,
                              Dv: int, causal: bool,
                              window: Optional[int]) -> int:
    """K2b: the scores again, dP = dO.V, dV, dQ and dK, 2.5 times the
    forward's products."""
    return int(2.5 * flash_attention_flops(B, H, S, Sk, D, Dv, causal,
                                           window))


def flash_decode_flops(B: int, H: int, S: int, D: int, Dv: int) -> int:
    """K3: one query against S cached positions in each of B x H heads."""
    return 2 * B * H * S * (D + Dv)


def ssd_flops(B: int, S: int, H: int, P: int, N: int, L: int) -> int:
    """Operations of one ssd_chunk call: per (b, chunk, head) the products
    C.B over s <= t, scores @ x over s <= t, and (w x)^T @ B."""
    tri = L * (L + 1) // 2
    return B * (S // L) * H * (tri * 2 * N + tri * 2 * P + 2 * L * P * N)


def ssd_bwd_flops(B: int, S: int, H: int, P: int, N: int, L: int
                  ) -> Dict[str, int]:
    """Operations the function of K4b needs with bf16 x, Bm and Cm, by the
    rate the card has for their operands: per (b, chunk), C B^T over s <=
    t (both bf16) and the products of dCB summed over the heads with B and
    C (dC and dB's second term); per head, dG = dy x^T and G^T dy over
    s <= t, Q = B dcontrib^T and x^T dcontrib.  Every product but C B^T
    has a float32 operand and counts as TF32 work at float32 accuracy:
    three TF32 products where both operands are float32 (G^T dy), two
    where the other operand is bf16 and so exact in TF32 (dC, dB's second
    term, dG, Q, x^T dcontrib)."""
    tri = L * (L + 1) // 2
    nbc = B * (S // L)
    return {"bfloat16": nbc * tri * 2 * N,
            "tf32": nbc * (2 * 2 * tri * 2 * N
                           + H * (2 * 2 * tri * P + 3 * 2 * tri * P
                                  + 2 * 2 * 2 * L * P * N))}


def matmul_flops(R: int, N: int, K: int, dtype: torch.dtype
                 ) -> Dict[str, int]:
    """K1 over R rows of K against N columns: int8 and bf16 at their
    tensor-core rates; float32 on FMAs on the skinny route (up to
    ``neutron_matmul.SKINNY_MAX_ROWS`` rows), else three TF32 products
    for each multiply-add (the tiled route's 3xTF32)."""
    flops = 2 * R * N * K
    if dtype != torch.float32:
        return {rate_of(dtype): flops}
    from .neutron_matmul import SKINNY_MAX_ROWS
    if R <= SKINNY_MAX_ROWS:
        return {"float32": flops}
    return {"tf32": 3 * flops}
