"""Data pipeline: deterministic, checkpointable token streams.

``TokenStream`` generates a synthetic-but-learnable token distribution
(order-2 Markov over a seeded transition table) so end-to-end training
examples show decreasing loss without external data.  ``FileCorpus``
memory-maps a flat binary token file.  Both expose an explicit
``state`` (seed, cursor) that the checkpointer persists, so restarts
resume the exact stream position (fault tolerance requirement).

A copy of ``repro.data.pipeline``, which is numpy only: the same seed
and step give the same batches in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class StreamState:
    seed: int
    step: int

    def to_dict(self) -> Dict:
        return {"seed": int(self.seed), "step": int(self.step)}

    @classmethod
    def from_dict(cls, d: Dict) -> "StreamState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class TokenStream:
    """Order-2 Markov synthetic corpus (deterministic per (seed, step))."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.state = StreamState(seed=seed, step=0)
        rng = np.random.default_rng(seed)
        # Keep the transition table small relative to the vocab: a reduced
        # test model then shows decreasing loss within tens of steps (first
        # from the marginal — only `modulus` of `vocab` tokens ever occur —
        # then from the transitions).  A near-vocab modulus makes the
        # stream practically unlearnable at test scale.
        self._modulus = max(2, min(vocab - 1, 127))
        self._mix = rng.integers(1, self._modulus, 2, dtype=np.int64)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.step) % (2 ** 63))
        b, s = self.batch, self.seq_len
        toks = np.empty((b, s + 1), np.int64)
        toks[:, :2] = rng.integers(0, self._modulus, (b, 2))
        noise = rng.random((b, s + 1)) < 0.05
        rand = rng.integers(0, self._modulus, (b, s + 1))
        for t in range(2, s + 1):
            nxt = (toks[:, t - 1] * self._mix[0]
                   + toks[:, t - 2] * self._mix[1]) % self._modulus
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        self.state.step += 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class FileCorpus:
    """Flat binary token file (uint16/uint32), sampled deterministically."""

    def __init__(self, path: str, vocab: int, batch: int, seq_len: int,
                 seed: int = 0, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.state = StreamState(seed=seed, step=0)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.step) % (2 ** 63))
        n = len(self.tokens) - self.seq_len - 1
        starts = rng.integers(0, n, self.batch)
        toks = np.stack([np.asarray(self.tokens[i:i + self.seq_len + 1])
                         for i in starts]).astype(np.int32)
        toks = np.clip(toks, 0, self.vocab - 1)
        self.state.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(source, extra: Optional[Dict] = None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    while True:
        batch = source.next_batch()
        if extra:
            batch.update(extra)
        yield batch
