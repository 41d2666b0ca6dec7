"""Task coordinator of the port (twin of repro.serving.router): least-loaded
dispatch over replicas with the lowest replica id breaking ties, or a
seeded draw when ``route_seed`` is given, all driven by the one serving
loop. A replica's worker follows the policy and the cache layout:

  * ``policy="continuous"``, ``cache_layout="paged"``: paged continuous
    batching (``PagedPipelineBatcher``); ``spec`` (a SpecConfig) turns on
    speculative decoding on every replica, ``spec_ks`` gives each replica
    its own depth (0 = plain decode there); ``kv_dtype`` sets every
    replica's page-pool precision, ``kv_dtypes`` each replica's own (a None
    entry takes ``kv_dtype``), and ``kv_guard_layers`` the global layer
    indices kept at model precision;
  * ``policy="continuous"``, ``cache_layout="contiguous"``: slot pools of
    ``max_len`` rows (``PipelineBatcher``);
  * ``policy="static"``: the paper's own engine, a whole left-padded
    batch of up to ``max_batch`` requests run to completion per iteration
    (``StaticBatcher``), whatever the layout.

As in the reference, a feature that the chosen policy and layout cannot
serve (speculation, prefix caching, chunked prefill and quantized pools
outside paged continuous batching) warns and serves without itself.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.continuous import (PagedPipelineBatcher,
                                            PipelineBatcher)
from repro_torch.serving.loop import ServeStats, WallClock, run_serve_loop
from repro_torch.serving.request import Request
from repro_torch.serving.spec import SpecConfig

__all__ = ["Router", "ServeStats", "StaticBatcher"]


class StaticBatcher:
    """The paper's engine as a loop worker: admitted requests accumulate up
    to max_batch and one iteration runs the whole left-padded batch to
    completion through ``replica.generate``, charging the virtual clock
    one step per generated position.

    ``max_len`` guards the replica's cache length: a request whose prompt
    + max_new_tokens cannot fit is rejected alone with an empty output
    (counted in ``ServeStats.rejected``). None = unbounded."""

    def __init__(self, replica, *, max_batch: int = 4, pad_id: int = 0,
                 max_len: Optional[int] = None,
                 virtual_step_cost: float = 1.0):
        self.replica = replica
        self.max_batch = max_batch
        self.pad_id = pad_id
        self.max_len = max_len
        self.virtual_step_cost = virtual_step_cost
        self.replica_id = 0
        self._queue: List[Request] = []
        self.rejected = 0

    # ---- replica port (serving.loop) -------------------------------------
    def capacity(self, now: float) -> int:
        return self.max_batch - len(self._queue)

    def load(self, now: float) -> float:
        return len(self._queue)

    def admit(self, reqs: Sequence[Request], now: float) -> None:
        self._queue.extend(reqs)

    def busy(self, now: float) -> bool:
        return bool(self._queue)

    def inflight(self) -> int:
        return len(self._queue)

    def next_event(self, now: float):
        return None

    def run_iteration(self, now: float):
        batch, self._queue = self._queue, []
        comps = []
        if self.max_len is not None:
            fits = []
            for r in batch:
                if len(r.prompt) + r.max_new_tokens > self.max_len - 1:
                    self.rejected += 1
                    warnings.warn(
                        f"request {r.rid}: prompt {len(r.prompt)} + "
                        f"max_new {r.max_new_tokens} exceeds the replica "
                        "cache length; rejected with empty output")
                    comps.append((r, np.zeros(0, np.int32), None))
                else:
                    fits.append(r)
            batch = fits
        if not batch:
            return comps, self.virtual_step_cost
        maxlen = max(len(r.prompt) for r in batch)
        toks = np.full((len(batch), maxlen), self.pad_id, np.int32)
        kv_start = np.zeros(len(batch), np.int32)
        for i, r in enumerate(batch):
            toks[i, maxlen - len(r.prompt):] = r.prompt        # left pad
            kv_start[i] = maxlen - len(r.prompt)
        max_new = max(r.max_new_tokens for r in batch)
        out = self.replica.generate(toks, max_new=max_new, kv_start=kv_start)
        comps.extend((r, out[i, :r.max_new_tokens], None)
                     for i, r in enumerate(batch))
        return comps, self.virtual_step_cost * max_new


class Router:
    def __init__(self, replicas, *, policy: str = "continuous",
                 cache_layout: str = "contiguous", max_batch: int = 4,
                 n_slots: int = 8, max_len: int = 256, block_size: int = 16,
                 stage_blocks=None, prefix_caching: bool = False,
                 prefill_chunk: int = 0, prefill_token_cost: float = 0.0,
                 step_costs: Optional[Sequence[float]] = None,
                 spec: Optional[SpecConfig] = None,
                 spec_ks: Optional[Sequence[int]] = None,
                 kv_dtype: Optional[str] = None,
                 kv_dtypes: Optional[Sequence[Optional[str]]] = None,
                 kv_guard_layers: Sequence[int] = (),
                 route_seed: Optional[int] = None):
        if policy not in ("continuous", "static"):
            raise ValueError(f"policy {policy!r}")
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout {cache_layout!r}")
        self.replicas = list(replicas)
        self.policy = policy
        self.cache_layout = cache_layout
        paged = policy == "continuous" and cache_layout == "paged"
        if spec is not None and not paged:
            warnings.warn(
                "speculative decoding needs policy='continuous' with "
                "cache_layout='paged' (multi-token verification runs "
                "through the paged context path); serving without it",
                stacklevel=2)
            spec = None
        if (prefix_caching or prefill_chunk) and not paged:
            warnings.warn(
                "prefix_caching / prefill_chunk need policy='continuous' "
                "with cache_layout='paged' (block-granular aliasing); "
                "serving without them", stacklevel=2)
            prefix_caching, prefill_chunk = False, 0
        if (kv_dtype is not None or kv_dtypes is not None) and not paged:
            warnings.warn(
                "kv_dtype needs policy='continuous' with "
                "cache_layout='paged' (precision is a page-pool layout); "
                "serving at model precision", stacklevel=2)
            kv_dtype, kv_dtypes = None, None
        if step_costs is None:
            step_costs = [1.0] * len(self.replicas)
        if len(step_costs) != len(self.replicas):
            raise ValueError("one step cost per replica")
        if spec_ks is not None and len(spec_ks) != len(self.replicas):
            raise ValueError("one spec depth per replica")
        if kv_dtypes is not None and len(kv_dtypes) != len(self.replicas):
            raise ValueError("one KV precision per replica")

        def replica_kv_dtype(i: int) -> Optional[str]:
            if kv_dtypes is not None and kv_dtypes[i] is not None:
                return kv_dtypes[i]
            return kv_dtype

        def replica_spec(i: int) -> Optional[SpecConfig]:
            if spec is None or spec_ks is None:
                return spec
            return dataclasses.replace(spec, k=spec_ks[i]) \
                if spec_ks[i] >= 1 else None
        if paged:
            self.workers = [PagedPipelineBatcher(
                r, n_slots=n_slots, max_len=max_len,
                block_size=block_size, stage_blocks=stage_blocks,
                prefix_caching=prefix_caching, prefill_chunk=prefill_chunk,
                prefill_token_cost=prefill_token_cost, virtual_step_cost=sc,
                replica_id=i, spec=replica_spec(i),
                kv_dtype=replica_kv_dtype(i), kv_guard_layers=kv_guard_layers)
                for i, (r, sc) in enumerate(zip(self.replicas, step_costs))]
        elif policy == "continuous":
            self.workers = [PipelineBatcher(r, n_slots=n_slots,
                                            max_len=max_len,
                                            virtual_step_cost=sc)
                            for r, sc in zip(self.replicas, step_costs)]
        else:
            if cache_layout == "paged":
                warnings.warn(
                    "cache_layout='paged' has no effect with "
                    "policy='static' (the whole-batch engine allocates "
                    "per-generate caches); serving contiguous",
                    stacklevel=2)
            self.workers = [StaticBatcher(r, max_batch=max_batch,
                                          max_len=max_len,
                                          virtual_step_cost=sc)
                            for r, sc in zip(self.replicas, step_costs)]
        # every worker carries its replica id (deterministic least-loaded
        # tiebreaks)
        for i, w in enumerate(self.workers):
            w.replica_id = i
        self._route_rng = (np.random.RandomState(route_seed)
                           if route_seed is not None else None)

    def _dispatch(self, cands, req: Request, now: float):
        """Admission choice (serving.loop hook): least-loaded; ties go to
        the lowest replica id, or by a seeded draw per candidate when the
        caller wants reproducible-but-shuffled routing benchmarks."""
        def key(w):
            tie = (self._route_rng.random() if self._route_rng is not None
                   else w.replica_id)
            return w.load(now), tie
        return min(cands, key=key)

    def serve(self, requests: Sequence[Request], deadline: float, *,
              clock=None) -> ServeStats:
        """Replays a timed workload; wall-clock by default, or any clock
        (VirtualClock for deterministic replay)."""
        return run_serve_loop(
            self.workers, requests, deadline=deadline,
            clock=clock if clock is not None else WallClock(),
            dispatch=self._dispatch)
