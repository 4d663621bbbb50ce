"""Deterministic synthetic token pipeline (host-shardable, prefetching).

The port's own copy of ``repro/data/pipeline.py`` (numpy only): the same
generator calls in the same order, so every batch is bit-equal to the
JAX package's for the same ``(seed, step, shard, n_shards)``.

Sequences are sampled from a fixed random *bigram* process, so the stream has
learnable structure: a model that trains correctly drives its loss from
~log(V) down toward the bigram entropy.  Every batch is a pure function of
``(seed, step, shard)``, so a restart resumes bit-exactly from the data
cursor in the checkpoint.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    seed: int = 0
    branch: int = 16      # candidate successors per token (entropy knob)

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab, 4096)         # bigram table over a vocab prefix
        self._v = v
        self.successors = rng.integers(0, v, size=(v, self.branch))

    def batch(self, step: int, batch_size: int, shard: int = 0,
              n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Batch for ``step`` restricted to this host shard (deterministic)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        b = batch_size // n_shards
        toks = np.empty((b, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self._v, size=b)
        choices = rng.integers(0, self.branch, size=(b, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = self.successors[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def bigram_entropy(self) -> float:
        """Per-token entropy of the generating process (loss floor), nats."""
        ent = 0.0
        for row in self.successors:
            _, counts = np.unique(row, return_counts=True)
            p = counts / counts.sum()
            ent += -(p * np.log(p)).sum()
        return float(ent / len(self.successors))


def make_batch_iterator(ds: SyntheticLM, batch_size: int, *, start_step: int = 0,
                        shard: int = 0, n_shards: int = 1,
                        prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator (the host-side input pipeline)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch(step, batch_size, shard, n_shards), timeout=0.5)
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
