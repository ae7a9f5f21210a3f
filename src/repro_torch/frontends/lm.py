"""LM decoder frontend — prefill and single-token decode Graphs.

Copy of the JAX package's ``frontends/lm.py`` (numpy only; the port
imports nothing of that package and keeps its own copy), with a
``device`` for :func:`compile_decoder`.  The tests hold its graphs and
weights equal to the original's.

The causal-operator subsystem's model builder: a tiny transformer
decoder block stack (pre-norm attention + MLP, the whisper-tiny /
GPT-2 layer shape) emitted as a :class:`repro_torch.core.ir.Graph` on the
NPU compile path.  Activations are laid out ``(S, 1, d_model)`` — the
sequence maps onto the H/row axis, so the compiler's row tiling *is*
token tiling and every existing scheduling/allocation pass applies
unchanged.

One graph definition covers both serving phases:

* **prefill** — ``seq = P`` prompt tokens, ``pos = 0``: every layer
  projects Q/K/V for all P rows, appends K/V at cache rows ``[0, P)``
  and runs causally-masked attention over them;
* **decode**  — ``seq = 1``, ``pos = t``: one new token appends at
  cache row ``t`` and attends to rows ``[0, t]``.

KV caches thread through the *static* graph as inputs **and** outputs:
each layer's ``kvappend`` takes the previous cache state plus the new
rows and produces the updated cache, which is marked as a model output
so :class:`repro_torch.api.DecodeSession` can feed it back as the next
step's input.  Cache capacity (``kv_len``) is a compile-time bucket —
``bucket_for`` picks the smallest configured bucket that fits, so all
requests at similar sequence positions share one compiled program (the
bucket enters the graph fingerprint through the cache shapes and each
attention op's ``kv_len`` attr, which keys the pipeline cache).

Weight sharing across variants: :class:`~repro_torch.core.ir.GraphBuilder`
names parameters by op-creation order and draws their values from a
seeded RNG keyed only by parameter *shape* order — the op sequence of
a decoder stack is independent of ``seq``/``kv_len``, so the prefill
graph, every decode bucket, and every grown bucket all carry
identically-named, identically-valued weights.  One calibration /
quantization result transfers across buckets (asserted in
``tests/test_lm_compile.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.core.ir import Graph, GraphBuilder, reference_execute

#: KV-cache capacity buckets (tokens).  A request is served at the
#: smallest bucket that fits its current sequence position; crossing a
#: bucket boundary re-targets the next-larger bucket's compiled program
#: (cache contents copy forward, weights are shared by construction).
SEQ_BUCKETS = (8, 16, 32, 64, 128)


@dataclass(frozen=True)
class LMSpec:
    """Decoder-stack dimensions (a scaled-down whisper-tiny decoder)."""

    name: str = "lm-tiny"
    n_layers: int = 2
    d_model: int = 48
    n_heads: int = 6
    d_ff: int = 192
    vocab: int = 96
    max_seq: int = 128
    act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def tiny_spec(scale: int = 8, n_layers: int = 2, vocab: int = 96,
              max_seq: int = 128) -> LMSpec:
    """Whisper-tiny decoder dims divided by ``scale`` (heads kept, so
    head_dim shrinks): the compile/serve path exercises the real layer
    topology at test-friendly cost."""
    c = WHISPER_TINY
    return LMSpec(name=f"lm-tiny-x{scale}", n_layers=n_layers,
                  d_model=c.d_model // scale, n_heads=c.n_heads,
                  d_ff=c.d_ff // scale, vocab=vocab, max_seq=max_seq,
                  act=c.act)


def bucket_for(n: int, buckets: Tuple[int, ...] = SEQ_BUCKETS) -> int:
    """Smallest configured bucket >= n (clamps to the largest)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


# --------------------------------------------------------------------------
# Graph builder
# --------------------------------------------------------------------------


def build_decoder(spec: LMSpec, seq: int, kv_len: int, seed: int = 0
                  ) -> Tuple[Graph, GraphBuilder]:
    """A ``seq``-token decoder step against ``kv_len``-capacity caches.

    Inputs: ``x`` (seq, 1, d_model) token embeddings, ``pos`` (1,1,1)
    tokens already in the cache, and per layer ``k_cache{L}`` /
    ``v_cache{L}`` (kv_len, 1, d_model).  Outputs: ``logits``
    (seq, 1, vocab) plus every layer's updated cache."""
    if not 1 <= seq <= kv_len:
        raise ValueError(f"seq {seq} must be in [1, kv_len {kv_len}]")
    d = spec.d_model
    b = GraphBuilder(f"{spec.name}-L{spec.n_layers}-s{seq}-kv{kv_len}",
                     seed=seed)
    x = b.input((seq, 1, d), name="x")
    pos = b.input((1, 1, 1), name="pos")
    cache_in: List[Tuple[str, str]] = []
    for L in range(spec.n_layers):
        cache_in.append((b.input((kv_len, 1, d), name=f"k_cache{L}"),
                         b.input((kv_len, 1, d), name=f"v_cache{L}")))

    h = x
    for L in range(spec.n_layers):
        k_in, v_in = cache_in[L]
        hn = b.layernorm(h)
        q = b.matmul(hn, d)
        kk = b.matmul(hn, d)
        vv = b.matmul(hn, d)
        k_new = b.kvappend(k_in, kk, pos)
        v_new = b.kvappend(v_in, vv, pos)
        att = b.attention(q, k_new, v_new, pos, heads=spec.n_heads)
        h = b.add(h, b.matmul(att, d))
        hn2 = b.layernorm(h)
        f1 = b.matmul(hn2, spec.d_ff, act=spec.act)
        h = b.add(h, b.matmul(f1, d))
        b.mark_output(k_new)
        b.mark_output(v_new)

    hf = b.layernorm(h)
    logits = b.matmul(hf, spec.vocab)
    b.mark_output(logits)
    g = b.build()
    return g, b


def cache_io(g: Graph) -> Dict[str, str]:
    """cache-input name -> cache-output name, from the graph itself
    (each ``kvappend`` rewrites exactly one cache)."""
    return {op.inputs[0]: op.outputs[0]
            for op in g.ops if op.kind == "kvappend"}


def logits_name(g: Graph) -> str:
    """The logits output (the only non-cache output)."""
    caches = set(cache_io(g).values())
    names = [t.name for t in g.outputs if t.name not in caches]
    assert len(names) == 1, names
    return names[0]


# --------------------------------------------------------------------------
# Embeddings + calibration
# --------------------------------------------------------------------------


def embedding_table(spec: LMSpec, seed: int = 0) -> np.ndarray:
    """Deterministic (vocab, d_model) token-embedding table, same
    small-int value family as the builder's weights (int8-friendly)."""
    rng = np.random.default_rng(seed + 7919)
    return (rng.integers(-4, 5, size=(spec.vocab, spec.d_model))
            .astype(np.float32) / 16.0)


def embed(table: np.ndarray, ids) -> np.ndarray:
    """Token ids -> (len(ids), 1, d_model) embedding rows."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    return table[ids][:, None, :].astype(np.float32)


def lm_calibration(g: Graph, weights: Dict[str, np.ndarray],
                   spec: LMSpec, samples: int = 6, seed: int = 0
                   ) -> List[Dict[str, np.ndarray]]:
    """Calibration feeds that walk a real decode: sample 0 starts from
    empty caches at pos 0, every later sample feeds the previous
    sample's *appended* caches back in with the position advanced.  The
    range observers therefore see actual K/V projection values (not
    synthetic noise) and every position of the bucket, which is what
    makes the tied cache qparams and the attention masks calibrated for
    the whole serving range."""
    rng = np.random.default_rng(seed)
    table = embedding_table(spec, seed)
    seq = g.tensors["x"].shape[0]
    io = cache_io(g)
    kv = g.tensors[next(iter(io))].shape[0]
    cache_feed = {name: np.zeros(g.tensors[name].shape, np.float32)
                  for name in io}
    pos = 0
    feeds: List[Dict[str, np.ndarray]] = []
    for _ in range(max(1, samples)):
        ids = rng.integers(0, spec.vocab, size=seq)
        feed = dict(cache_feed)
        feed["x"] = embed(table, ids)
        feed["pos"] = np.full((1, 1, 1), float(pos), np.float32)
        feeds.append(feed)
        vals = reference_execute(g, feed, weights)
        cache_feed = {ci: vals[co] for ci, co in io.items()}
        pos = min(pos + seq, max(kv - seq, 0))
    return feeds


# --------------------------------------------------------------------------
# Compile helper (PTQ-aware)
# --------------------------------------------------------------------------


def compile_decoder(spec: LMSpec, seq: int, kv_len: int,
                    precision: str = "float32", config=None,
                    options=None, seed: int = 0,
                    calib_samples: int = 6, cache: bool = True,
                    device=None):
    """Build + compile one decoder variant into a
    :class:`repro_torch.api.CompiledModel` that replays on ``device``
    (CUDA unless the caller asks for the CPU).  ``precision="int8"`` runs
    the PTQ flow over :func:`lm_calibration` feeds (decode-realistic
    cache states), not the generic synthetic set."""
    import repro_torch.api as api
    from repro_torch import quant

    g, b = build_decoder(spec, seq, kv_len, seed=seed)
    if precision == "int8":
        weights = dict(b._weights)
        feeds = lm_calibration(g, weights, spec, samples=calib_samples,
                               seed=seed)
        table = quant.calibrate(g, weights, feeds)
        qm = quant.quantize_graph(g, weights, table)
        quant.measure_quant_error(qm, feeds)
        return api.compile(qm, config, options, cache=cache,
                           name=g.name, calibration=table, device=device)
    return api.compile((g, b), config, options, precision=precision,
                       cache=cache, name=g.name, device=device)
