"""Streaming LM decode serving — compile once, reuse per token, on the GPU.

Counterpart of ``repro/api/decode.py``.  :class:`DecodeSession` compiles
the prefill and single-token decode graphs of
:mod:`repro_torch.frontends.lm` once per (sequence, KV-bucket) shape and
then streams tokens by replaying the *same* cached per-step
:class:`~repro_torch.core.execplan.ExecPlan` every token — zero
re-lowering after warmup (``CompiledModel._plan_stats['builds']`` is
frozen; ``stats()`` reports it per shape).

Everything a request holds lives on the session's device (CUDA unless
the caller asks for the CPU): its KV caches are float32 tensors keyed by
the graph's cache-*input* names, the embedding table is uploaded once,
and the greedy argmax runs on the device.  A step feeds the caches and
one embedding row to the plan, which quantizes them into its arena at
int8, and the step's appended cache *outputs* (copies, never arena
views) become the request's state for the next token, so concurrent
requests never share mutable cache storage.  The only device-to-host
read of a step is its token, which ``prefill`` and ``step`` return as a
Python int.

Sequence-position bucketing is the reference's: a request is served at
the smallest configured KV bucket that fits its position; crossing a
boundary copies the caches, on the device, into the next bucket's zeros
and switches to that bucket's compiled model (weights are shared across
buckets by the builder's deterministic naming).

Per-token observability: with :mod:`repro_torch.obs.trace` armed, every
prefill and decode step emits a span carrying the request's trace id
(``lm.prefill``, ``lm.decode_step``; ``lm.compile`` per shape and the
instant ``lm.bucket_grow``).  On CUDA a span is host time: the step's
enqueue plus the wait for its token.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.obs import trace as _trace

_rids = itertools.count(1)


@dataclass
class _Request:
    rid: str
    trace_id: int
    bucket: int
    pos: int                               # tokens currently in cache
    caches: Dict[str, torch.Tensor]        # cache-input name -> float32
    tokens: List[int] = field(default_factory=list)  # prompt + generated


class DecodeSession:
    """Compile-and-stream serving for the tiny LM decoder on ``device``.

    ::

        sess = DecodeSession(precision="int8")          # on CUDA
        rid, tok = sess.prefill([3, 17, 42])
        for tok in sess.stream(rid, max_new_tokens=16):
            ...
    """

    def __init__(self, spec=None, precision: str = "float32",
                 config=None, options=None, seed: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 cache: bool = True, device=None):
        from repro_torch.frontends import lm
        self._lm = lm
        self.device = resolve_device(device)
        self.spec = spec or lm.tiny_spec()
        self.precision = precision
        self.config = config
        self.options = options
        self.seed = seed
        self.buckets = tuple(buckets or lm.SEQ_BUCKETS)
        self._cache = cache
        self._models: Dict[tuple, object] = {}   # (seq, kv) -> CompiledModel
        self._requests: Dict[str, _Request] = {}
        self._emb = torch.from_numpy(
            lm.embedding_table(self.spec, seed)).to(self.device)

    # -- compiled-model pool ------------------------------------------------
    def model(self, seq: int, kv_len: int):
        """The compiled model serving (seq, kv_len) — compiled on first
        use, then reused for every request at that shape (its per-step
        ExecPlan is cached inside the CompiledModel)."""
        key = (seq, kv_len)
        m = self._models.get(key)
        if m is None:
            with _trace.maybe_span("lm.compile", "serve",
                                   seq=seq, kv=kv_len):
                m = self._lm.compile_decoder(
                    self.spec, seq, kv_len, precision=self.precision,
                    config=self.config, options=self.options,
                    seed=self.seed, cache=self._cache, device=self.device)
            self._models[key] = m
        return m

    def _run(self, m, feed: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        return m(feed)            # plan engine; unbatched shapes

    def _pos(self, pos: int) -> torch.Tensor:
        # filled on the device: no host-to-device copy to wait for
        return torch.full((1, 1, 1), float(pos), dtype=torch.float32,
                          device=self.device)

    # -- request lifecycle --------------------------------------------------
    def prefill(self, prompt_ids: Sequence[int],
                rid: Optional[str] = None) -> tuple:
        """Run the prompt through the prefill graph; returns
        ``(rid, first_token)`` with the request's KV caches populated at
        rows ``[0, len(prompt))``.

        The prompt is right-padded with zero embeddings up to the
        prefill sequence bucket; padded rows are invisible by
        construction — the causal mask hides rows past ``pos`` and
        every later decode step overwrites its own cache row before
        unmasking it."""
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("prefill needs at least one prompt token")
        p = len(prompt)
        if not all(0 <= t < self.spec.vocab for t in prompt):
            # an index past the table would fault the device, not raise
            raise ValueError(f"prompt ids must lie in [0, "
                             f"{self.spec.vocab})")
        if p + 1 > self.buckets[-1]:
            raise ValueError(
                f"prompt of {p} tokens exceeds the largest KV bucket "
                f"({self.buckets[-1]}) — raise `buckets`")
        rid = rid or f"req-{next(_rids)}"
        if rid in self._requests:
            raise ValueError(f"request {rid!r} already active")
        trace_id = _trace.new_trace_id()
        kv = self._lm.bucket_for(p + 1, self.buckets)
        sq = self._lm.bucket_for(p, self.buckets)
        m = self.model(sq, kv)
        g = m.graph
        io = self._lm.cache_io(g)

        dev = self.device
        x = torch.zeros((sq, 1, self.spec.d_model), dtype=torch.float32,
                        device=dev)
        x[:p, 0] = self._emb[torch.tensor(prompt, device=dev)]
        feed: Dict[str, torch.Tensor] = {"x": x, "pos": self._pos(0)}
        for ci in io:
            feed[ci] = torch.zeros(g.tensors[ci].shape, dtype=torch.float32,
                                   device=dev)

        tr = _trace.active()
        t0 = tr.clock() if tr else 0.0
        out = self._run(m, feed)
        tok = int(out[self._lm.logits_name(g)][p - 1, 0].argmax())
        if tr:
            tr.complete("lm.prefill", "serve", t0, trace_id=trace_id,
                        args={"rid": rid, "tokens": p, "bucket": kv})

        self._requests[rid] = _Request(
            rid=rid, trace_id=trace_id, bucket=kv, pos=p,
            caches={ci: out[co] for ci, co in io.items()},
            tokens=prompt + [tok])
        return rid, tok

    def step(self, rid: str) -> int:
        """One greedy decode step: feed the request's last token through
        the cached single-token plan, append its K/V at row ``pos``,
        advance, and return the argmax token."""
        r = self._requests[rid]
        if r.pos + 1 > self.buckets[-1]:
            raise RuntimeError(
                f"{rid}: KV capacity exhausted at {r.pos} tokens "
                f"(largest bucket {self.buckets[-1]})")
        if r.pos + 1 > r.bucket:
            self._grow(r)
        m = self.model(1, r.bucket)
        g = m.graph
        io = self._lm.cache_io(g)
        feed: Dict[str, torch.Tensor] = {
            "x": self._emb[r.tokens[-1]].view(1, 1, -1),
            "pos": self._pos(r.pos)}
        feed.update(r.caches)

        tr = _trace.active()
        t0 = tr.clock() if tr else 0.0
        out = self._run(m, feed)
        tok = int(out[self._lm.logits_name(g)][0, 0].argmax())
        if tr:
            tr.complete("lm.decode_step", "serve", t0,
                        trace_id=r.trace_id,
                        args={"rid": rid, "pos": r.pos, "token": tok})

        r.caches = {ci: out[co] for ci, co in io.items()}
        r.pos += 1
        r.tokens.append(tok)
        return tok

    def _grow(self, r: _Request) -> None:
        """Copy the request's caches into the next bucket's zeros, on the
        device, and re-target its compiled model (weights shared across
        buckets, so nothing warm recompiles)."""
        new_kv = self._lm.bucket_for(r.pos + 1, self.buckets)
        grown: Dict[str, torch.Tensor] = {}
        for ci, arr in r.caches.items():
            big = arr.new_zeros((new_kv,) + tuple(arr.shape[1:]))
            big[:arr.shape[0]] = arr
            grown[ci] = big
        _trace.instant("lm.bucket_grow", "serve", trace_id=r.trace_id,
                       args={"rid": r.rid, "from": r.bucket, "to": new_kv})
        r.caches = grown
        r.bucket = new_kv

    def stream(self, rid: str, max_new_tokens: int) -> Iterator[int]:
        """Yield up to ``max_new_tokens`` greedy tokens for an active
        request (the prefill's first token was already returned)."""
        for _ in range(max_new_tokens):
            yield self.step(rid)

    def generate(self, prompt_ids: Sequence[int],
                 max_new_tokens: int = 8) -> List[int]:
        """Prefill + decode loop; returns the generated tokens (the
        prefill's first token included).  The request is closed when
        done."""
        rid, tok = self.prefill(prompt_ids)
        toks = [tok]
        try:
            toks.extend(self.stream(rid, max_new_tokens - 1))
        finally:
            self.finish(rid)
        return toks

    def finish(self, rid: str) -> None:
        self._requests.pop(rid, None)

    # -- reporting ----------------------------------------------------------
    def active_requests(self) -> List[str]:
        return sorted(self._requests)

    def tokens(self, rid: str) -> List[int]:
        return list(self._requests[rid].tokens)

    def stats(self) -> Dict[str, object]:
        """Per-compiled-model plan-cache statistics — the zero-relowering
        check reads ``builds`` here."""
        return {f"s{sq}/kv{kv}": {
                    "source": m.source,
                    "plan": dict(m._plan_stats)}
                for (sq, kv), m in sorted(self._models.items())}
