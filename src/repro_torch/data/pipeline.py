"""Deterministic, shardable, resumable data pipeline.

Design points for the 1000-node regime:
  * **determinism**: batch ``t`` is a pure function of (seed, t) — after a
    restart the loop skips to the checkpointed cursor and sees exactly the same
    stream (MapReduce's re-execution guarantee at job granularity).
  * **sharding**: each host materializes only its slice of the global batch.
  * **prefetch**: a one-slot background thread hides host-side latency
    (the place stragglers actually appear on real fleets).
  * **dedup stage**: optional diversity sampling (paper §III-A-1).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from .dedup import dedup as _dedup


class ShardedBatches:
    def __init__(self, X: np.ndarray, y: Optional[np.ndarray], *,
                 global_batch: int, seed: int = 0,
                 shard_index: int = 0, shard_count: int = 1,
                 drop_duplicates: bool = False, max_dup: int = 1,
                 start_step: int = 0):
        if drop_duplicates:
            out = _dedup(X, y, max_dup=max_dup)
            X = out[0]
            y = out[1] if y is not None else None
        assert global_batch % shard_count == 0
        self.X, self.y = X, y
        self.global_batch = global_batch
        self.local_batch = global_batch // shard_count
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.step = start_step
        self.n = len(X)

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 1_000_003 + epoch) % (2**31))
        return rng.permutation(self.n)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step — the resumability contract."""
        per_epoch = self.n // self.global_batch
        epoch = step // max(1, per_epoch)
        within = step % max(1, per_epoch)
        perm = self._perm(epoch)
        lo = within * self.global_batch
        idx = perm[lo:lo + self.global_batch]
        sl = idx[self.shard_index * self.local_batch:
                 (self.shard_index + 1) * self.local_batch]
        out = {"x": self.X[sl]}
        if self.y is not None:
            out["y"] = self.y[sl]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict):
        self.step = int(state["step"])
        assert int(state["seed"]) == self.seed, "seed mismatch on resume"


class Prefetcher:
    """One-slot background prefetch (double buffering)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def token_batches(vocab: int, global_batch: int, seq_len: int, *, seed: int = 0,
                  shard_index: int = 0, shard_count: int = 1,
                  start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic LM token stream with in-context structure (Zipfian bigram
    chains) — deterministic per step, for the end-to-end LM driver."""
    local = global_batch // shard_count
    step = start_step
    # fixed random bigram successor table gives learnable structure
    rng0 = np.random.RandomState(seed)
    succ = rng0.randint(0, vocab, (vocab, 4))
    while True:
        rng = np.random.RandomState((seed * 7_777_777 + step * shard_count
                                     + shard_index) % (2**31))
        toks = np.empty((local, seq_len), np.int32)
        toks[:, 0] = rng.randint(0, vocab, local)
        choice = rng.randint(0, 4, (local, seq_len))
        noise = rng.random((local, seq_len)) < 0.1
        rand_tok = rng.randint(0, vocab, (local, seq_len))
        for t in range(1, seq_len):
            nxt = succ[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        yield {"tokens": toks}
        step += 1
