"""Data pipeline: deterministic synthetic LM stream + ragged document packing.
A copy of ``repro.data.pipeline`` (numpy only): the same arrays, byte for
byte.

Production properties kept honest at container scale:
  * host-sharded: each data-parallel host materializes only its shard
    (``shard_index`` / ``shard_count``);
  * stateless & restartable: batch t is a pure function of (seed, t) — after
    a fault-tolerance restore the stream resumes exactly (no iterator state
    in checkpoints);
  * double-buffered prefetch (background thread) hides host latency;
  * ragged packing with whilelt predicates instead of padding waste —
    documents shorter than seq_len yield per-row ``lens`` consumed by the
    predicated attention masks (the paper's C2/C3 applied to the input path).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    """Deterministic synthetic token stream with document structure.

    Documents have power-law lengths; tokens follow a mixed unigram process
    seeded per (seed, doc_id) so any shard/step is reproducible in isolation.
    """

    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 mean_doc_len: int = 512):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        self.mean_doc_len = mean_doc_len

    def batch(self, step: int, batch_size: int, *, shard_index: int = 0,
              shard_count: int = 1):
        """(tokens, labels, lens) for global step ``step``, host shard only."""
        assert batch_size % shard_count == 0
        local = batch_size // shard_count
        rows = np.arange(local) + shard_index * local + step * batch_size
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=rows[0]))
        toks = np.empty((local, self.seq_len + 1), np.int32)
        lens = np.empty((local,), np.int32)
        for i, row in enumerate(rows):
            r = np.random.Generator(np.random.Philox(key=self.seed, counter=row))
            ln = int(np.clip(r.geometric(1.0 / self.mean_doc_len),
                             8, self.seq_len))
            # token process: unigram with a row-specific hot region (learnable)
            base = r.integers(0, self.vocab_size, size=self.seq_len + 1)
            hot = r.integers(0, max(self.vocab_size // 16, 1))
            mask = r.random(self.seq_len + 1) < 0.7
            toks[i] = np.where(mask, hot + (base % 7), base).astype(np.int32)
            toks[i] %= self.vocab_size
            toks[i, ln:] = 0
            lens[i] = ln
        tokens = toks[:, :-1]
        labels = toks[:, 1:].copy()
        # predicated loss: ignore positions at/after each row's length
        cols = np.arange(self.seq_len)[None, :]
        labels[cols >= (lens[:, None] - 1)] = -1
        return tokens, labels, lens


def pack_documents(docs: list[np.ndarray], seq_len: int, pad_id: int = 0):
    """Greedy ragged packing: concatenate docs into rows of <= seq_len.

    Returns (tokens (N, seq_len), lens (N,)): the tail of each row past
    ``lens`` is inert under the whilelt predicates downstream.
    """
    rows, lens = [], []
    cur: list[int] = []
    for d in docs:
        d = list(int(x) for x in d)
        while d:
            space = seq_len - len(cur)
            take = d[:space]
            cur.extend(take)
            d = d[space:]
            if len(cur) == seq_len:
                rows.append(cur)
                lens.append(seq_len)
                cur = []
    if cur:
        lens.append(len(cur))
        rows.append(cur + [pad_id] * (seq_len - len(cur)))
    return (np.asarray(rows, np.int32),
            np.asarray(lens, np.int32))


def make_batches(source: SyntheticLM, batch_size: int, *, start_step: int = 0,
                 shard_index: int = 0, shard_count: int = 1,
                 prefetch: int = 2, stop_step: Optional[int] = None) -> Iterator:
    """Double-buffered batch iterator (background producer thread)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set() and (stop_step is None or step < stop_step):
            q.put((step, source.batch(step, batch_size,
                                      shard_index=shard_index,
                                      shard_count=shard_count)))
            step += 1
        q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            yield item
    finally:
        stop.set()
