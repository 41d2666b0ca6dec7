"""Deterministic synthetic token pipeline (no external datasets offline);
the port's copy of repro.training.data, numpy only, so that the same
(seed, step) gives the same batch in both packages.

Generates a stationary Markov-chain token stream per document: next-token
structure a model can actually learn (loss decreases measurably within a few
hundred steps), unlike uniform noise. Batches are reproducible from (seed,
step) so the pipeline is stateless and restart-safe — checkpoint resume
replays the exact stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    markov_states: int = 64


class SyntheticStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k = min(cfg.markov_states, cfg.vocab_size)
        # sparse-ish row-stochastic transition over a k-token active set
        self.active = rng.choice(cfg.vocab_size, size=k, replace=False)
        raw = rng.random((k, k)) ** 4          # peaky rows
        self.trans = raw / raw.sum(1, keepdims=True)
        self.k = k

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        states = rng.integers(0, self.k, size=cfg.batch_size)
        toks = np.empty((cfg.batch_size, cfg.seq_len), np.int32)
        # vectorized chain sampling via inverse-CDF per step
        cdf = np.cumsum(self.trans, axis=1)
        for t in range(cfg.seq_len):
            toks[:, t] = self.active[states]
            u = rng.random(cfg.batch_size)
            states = (cdf[states] < u[:, None]).sum(1).clip(0, self.k - 1)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
