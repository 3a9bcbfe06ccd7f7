"""Data pipeline (a copy of ``repro.data.pipeline``, numpy only):
deterministic synthetic LM streams + memmap token files
with data-parallel sharding and background prefetch.

Determinism contract (needed for fault-tolerant restart): batch content is
a pure function of (seed, shard, step) — a restarted task replays exactly
the batches it would have seen.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def make_lm_batch(tokens: np.ndarray) -> Dict[str, np.ndarray]:
    """Next-token-prediction batch from (B, S+1) raw tokens."""
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic token stream (vocab-bounded Zipf-ish mix)."""
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, self.shard, 0, 0]))
        raw = rng.integers(0, self.vocab_size,
                           size=(self.batch_size, self.seq_len + 1),
                           dtype=np.int64)
        # inject local structure so the loss is learnable (repeat motifs)
        rep = rng.integers(0, self.vocab_size, size=(self.batch_size, 8))
        for i in range(0, self.seq_len, 32):
            w = min(8, self.seq_len + 1 - i)
            raw[:, i:i + w] = rep[:, :w]
        return make_lm_batch(raw)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def write_token_file(path: str, tokens: np.ndarray) -> None:
    tokens = np.asarray(tokens, dtype=np.uint32)
    with open(path, "wb") as f:
        f.write(tokens.tobytes())


@dataclasses.dataclass
class TokenFileDataset:
    """Memmap-backed token file, sharded over data-parallel ranks.

    Rank r reads sequence windows [r::num_shards] — disjoint coverage, and
    a restart at step k resumes at exactly window k (determinism contract).
    """
    path: str
    seq_len: int
    batch_size: int
    shard: int = 0
    num_shards: int = 1
    prefetch: int = 2

    def __post_init__(self):
        self._mm = np.memmap(self.path, dtype=np.uint32, mode="r")
        self.n_windows = (len(self._mm) - 1) // self.seq_len

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        out = np.empty((self.batch_size, self.seq_len + 1), np.uint32)
        for i in range(self.batch_size):
            w = ((step * self.batch_size + i) * self.num_shards
                 + self.shard) % self.n_windows
            s = w * self.seq_len
            out[i] = self._mm[s:s + self.seq_len + 1]
        return make_lm_batch(out)

    def __iter__(self):
        return prefetched(self.batch, self.prefetch)


def prefetched(batch_fn, depth: int = 2) -> Iterator:
    """Background-thread prefetch of batch_fn(0), batch_fn(1), ..."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = 0
        while not stop.is_set():
            try:
                q.put(batch_fn(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
