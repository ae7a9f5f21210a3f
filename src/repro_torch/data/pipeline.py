"""Deterministic synthetic LM data pipeline with host-shard prefetch: a
copy of ``repro/data/pipeline.py`` (numpy only), so that the port and the
reference train on the same batches.

Production posture: each host process generates only its shard of the
global batch (``host_id``/``n_hosts``), double-buffered on a background
thread so step N+1's batch is ready before step N finishes (the data-side
DAE of the paper — input fetch hidden behind compute).  Determinism: the
token block for global step *s* is a pure function of (seed, s), so a
restarted/elastic job resumes bit-identically from any step.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def batch_for_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The (deterministic) host-local batch of global step `step`.

    A Zipf-ish marginal over the vocab with a shifted-copy structure so
    the LM loss actually decreases (next token correlates with current)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab
    base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
    tokens = np.minimum(base - 1, V - 1).astype(np.int32)
    # inject learnable structure: 50% of positions repeat t-1 plus one
    mask = rng.random((B, S)) < 0.5
    shifted = np.roll(tokens, 1, axis=1)
    tokens = np.where(mask, np.minimum(shifted + 1, V - 1), tokens)
    return {"tokens": tokens, "labels": tokens.copy()}


class Pipeline:
    """Background-thread prefetching iterator over deterministic steps."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self._step
        while not self._stop.is_set():
            b = batch_for_step(self.cfg, s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, b = self._q.get()
        self._step = step + 1
        return b

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
