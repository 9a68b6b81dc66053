"""Token data pipeline: synthetic + memmap-backed sources, sequence packing,
deterministic shard-aware batching.

Designed for the multi-host case: every host computes the same global batch
order from (seed, step) and slices its own shard — restart-safe (the trainer
checkpoints the step, the pipeline is stateless given step).

A copy of ``repro.data.pipeline`` for the port, unchanged but for this
paragraph: it is numpy only, and the trainer moves each batch to its device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"     # synthetic | memmap
    path: str = ""                # token file (np.uint32 memmap) for memmap
    pack: bool = True


class TokenSource:
    def tokens_for(self, idx: np.ndarray, n: int) -> np.ndarray:
        raise NotImplementedError


class SyntheticSource(TokenSource):
    """Zipf-ish synthetic tokens with local structure (ngram repetition) so
    a trained model shows a decreasing loss (used by examples/tests)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def tokens_for(self, idx: np.ndarray, n: int) -> np.ndarray:
        out = np.empty((len(idx), n), dtype=np.int32)
        for row, i in enumerate(idx):
            rng = np.random.default_rng(self.cfg.seed * 100003 + int(i))
            # zipf-distributed unigrams
            toks = rng.zipf(1.3, size=n).astype(np.int64)
            toks = toks % max(self.cfg.vocab - 2, 1) + 1
            # inject repeated trigrams -> learnable structure
            tri = rng.integers(1, self.cfg.vocab, size=3)
            for pos in range(0, n - 3, 16):
                if rng.random() < 0.5:
                    toks[pos:pos + 3] = tri
            out[row] = toks.astype(np.int32)
        return out


class MemmapSource(TokenSource):
    """Flat token file (uint16/uint32) with random-window sampling."""

    def __init__(self, cfg: DataConfig):
        dtype = np.uint32
        size = os.path.getsize(cfg.path)
        self._mm = np.memmap(cfg.path, dtype=dtype, mode="r",
                             shape=(size // dtype().itemsize,))
        self.cfg = cfg

    def tokens_for(self, idx: np.ndarray, n: int) -> np.ndarray:
        max_start = len(self._mm) - n - 1
        out = np.empty((len(idx), n), dtype=np.int32)
        for row, i in enumerate(idx):
            rng = np.random.default_rng(self.cfg.seed * 7919 + int(i))
            s = int(rng.integers(0, max_start))
            out[row] = np.asarray(self._mm[s:s + n], dtype=np.int32)
        return out


class DataPipeline:
    """Deterministic (seed, step) -> global batch -> per-shard slice."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 shard_count: int = 1):
        assert cfg.global_batch % shard_count == 0, \
            "global batch must divide across data shards"
        self.cfg = cfg
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.local_batch = cfg.global_batch // shard_count
        self.source = (SyntheticSource(cfg) if cfg.source == "synthetic"
                       else MemmapSource(cfg))

    def batch_at(self, step: int) -> dict:
        """{"tokens": (local_B, S), "labels": (local_B, S)} for this shard."""
        cfg = self.cfg
        base = np.arange(cfg.global_batch, dtype=np.int64) \
            + step * cfg.global_batch
        mine = base[self.shard_index * self.local_batch:
                    (self.shard_index + 1) * self.local_batch]
        toks = self.source.tokens_for(mine, cfg.seq_len + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
