"""Task coordinator of the port (twin of repro.serving.router.Router for
``policy="continuous"`` with ``cache_layout="paged"``): one paged
continuous-batching worker per replica, least-loaded dispatch with the
lowest replica id breaking ties, or a seeded draw when ``route_seed`` is
given, all driven by the one serving loop.
``spec`` (a SpecConfig) turns on speculative decoding on every replica;
``spec_ks`` gives each replica its own depth (0 = plain decode there).
``kv_dtype`` sets every replica's page-pool precision, ``kv_dtypes`` each
replica's own (a None entry takes ``kv_dtype``), and ``kv_guard_layers``
the global layer indices kept at model precision."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.serving.continuous import PagedPipelineBatcher
from repro_torch.serving.loop import ServeStats, WallClock, run_serve_loop
from repro_torch.serving.request import Request
from repro_torch.serving.spec import SpecConfig

__all__ = ["Router", "ServeStats"]


class Router:
    def __init__(self, replicas, *, policy: str = "continuous",
                 cache_layout: str = "paged", n_slots: int = 8,
                 max_len: int = 256, block_size: int = 16,
                 stage_blocks=None, prefix_caching: bool = False,
                 prefill_chunk: int = 0, prefill_token_cost: float = 0.0,
                 step_costs: Optional[Sequence[float]] = None,
                 spec: Optional[SpecConfig] = None,
                 spec_ks: Optional[Sequence[int]] = None,
                 kv_dtype: Optional[str] = None,
                 kv_dtypes: Optional[Sequence[Optional[str]]] = None,
                 kv_guard_layers: Sequence[int] = (),
                 route_seed: Optional[int] = None):
        if policy != "continuous" or cache_layout != "paged":
            raise NotImplementedError(
                f"policy={policy!r}, cache_layout={cache_layout!r}: the port "
                "serves continuous batching over paged caches only so far "
                "(static batching and the contiguous layout: ROADMAP.md, "
                "slice 5)")
        self.replicas = list(replicas)
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
        self.workers = [PagedPipelineBatcher(
            r, n_slots=n_slots, max_len=max_len,
            block_size=block_size, stage_blocks=stage_blocks,
            prefix_caching=prefix_caching, prefill_chunk=prefill_chunk,
            prefill_token_cost=prefill_token_cost, virtual_step_cost=sc,
            replica_id=i, spec=replica_spec(i),
            kv_dtype=replica_kv_dtype(i), kv_guard_layers=kv_guard_layers)
            for i, (r, sc) in enumerate(zip(self.replicas, step_costs))]
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
