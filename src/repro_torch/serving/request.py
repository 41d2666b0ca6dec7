"""Requests and synthetic workloads (Poisson arrivals, §5.1); a copy of
repro.serving.request, so both packages replay identical workloads."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (s,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0
    # filled by the engine; None means "never happened" — a request the
    # loop stranded keeps finish_time None and is accounted as dropped
    # (never as a negative latency)
    output: Optional[np.ndarray] = None
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    first_token_time: Optional[float] = None   # TTFT (prefix/chunk benches)
    # disaggregated serving: when the prefill replica handed the KV off
    # (first_token_time - prefill_finish_time = transfer + decode queueing)
    prefill_finish_time: Optional[float] = None

    @property
    def latency(self) -> float:
        """Only meaningful once finish_time is stamped; ServeStats guards."""
        return self.finish_time - self.arrival

    @property
    def served(self) -> bool:
        """Finished with the tokens it asked for (not rejected/stranded)."""
        if self.finish_time is None:
            return False
        if (self.output is not None and len(self.output) == 0
                and self.max_new_tokens > 0):
            return False               # rejected with an empty output
        return True


def synth_workload(*, rate: float, duration: float, vocab: int,
                   prompt_len: int = 32, prompt_jitter: int = 8,
                   out_len: int = 16, seed: int = 0) -> List[Request]:
    """Poisson arrivals with near-uniform prompt lengths."""
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    rid = 0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > duration:
            break
        plen = prompt_len + int(rng.integers(0, prompt_jitter + 1))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
            max_new_tokens=out_len,
            arrival=t))
        rid += 1
    return reqs


def shared_prefix_workload(*, rate: float, duration: float, vocab: int,
                           shared_len: int = 48, unique_len: int = 8,
                           unique_jitter: int = 4, out_len: int = 8,
                           n_prefixes: int = 1, seed: int = 0
                           ) -> List[Request]:
    """Poisson arrivals where every prompt = one of `n_prefixes` shared
    system prompts + a unique user tail — the multi-user regime where
    prefix caching deduplicates the dominant prefill cost (the system
    prompt is >= shared_len / (shared_len + unique_len) of every prompt).
    """
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, size=shared_len).astype(np.int32)
                for _ in range(max(n_prefixes, 1))]
    reqs = []
    t = 0.0
    rid = 0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > duration:
            break
        tail_len = unique_len + int(rng.integers(0, unique_jitter + 1))
        tail = rng.integers(0, vocab, size=tail_len).astype(np.int32)
        prefix = prefixes[rid % len(prefixes)]
        reqs.append(Request(
            rid=rid,
            prompt=np.concatenate([prefix, tail]),
            max_new_tokens=out_len,
            arrival=t))
        rid += 1
    return reqs
