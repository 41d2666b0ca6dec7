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

On the paged layout ``roles`` splits prefill and decode across replicas
(serving.disagg: prefill replicas hand their finished prompts' pages to
the least-loaded decode replica over ``kv_link``), ``host_blocks`` gives
each replica a host page tier, ``cluster_prefix`` joins the replicas in one
prefix directory (serving.cluster_kv), whose resident prefixes then weigh
into admission (``prefix_route_weight``, ``host_route_weight``), and
``kvsan`` serves under the KVSAN sanitizer. ``serve(..., tracer=,
metrics=)`` binds a tracer to every worker and publishes the replay's
counters into a metrics registry.

As in the reference, a feature that the chosen policy and layout cannot
serve (speculation, prefix caching, chunked prefill, quantized pools, the
tiers, disaggregation and KVSAN outside paged continuous batching) warns
and serves without itself, and a disaggregated group's replicas share one
pool precision (the narrowest chosen).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.block_manager import chunk_hashes
from repro_torch.serving.cluster_kv import wire_cluster_prefix
from repro_torch.serving.continuous import (PagedPipelineBatcher,
                                            PipelineBatcher)
from repro_torch.serving.disagg import KVLink, wire_disaggregation
from repro_torch.serving.loop import ServeStats, WallClock, run_serve_loop
from repro_torch.serving.pipeline import context_mode_supported
from repro_torch.serving.request import Request
from repro_torch.serving.spec import SpecConfig

__all__ = ["Router", "ServeStats", "StaticBatcher", "default_roles"]


def default_roles(n_replicas: int) -> List[str]:
    """Default disaggregated role split: decode replicas hold KV for a
    request's whole lifetime while prefill replicas turn requests over per
    prompt, so lean decode-heavy — floor(n/3) prefill replicas, at least
    one of each. The scheduler's role search (core.genetic) replaces this
    with an SLO-scored split."""
    n_prefill = max(1, n_replicas // 3)
    return ["prefill"] * n_prefill + ["decode"] * (n_replicas - n_prefill)


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
                 host_blocks=0, host_swap_cost: float = 0.0,
                 cluster_prefix: bool = False,
                 prefix_route_weight: float = 0.25,
                 host_route_weight: float = 0.5,
                 route_seed: Optional[int] = None,
                 roles: Optional[Sequence[str]] = None,
                 kv_link: Optional[KVLink] = None,
                 kvsan: bool = False):
        if policy not in ("continuous", "static"):
            raise ValueError(f"policy {policy!r}")
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout {cache_layout!r}")
        self.replicas = list(replicas)
        self.policy = policy
        self.cache_layout = cache_layout
        self.block_size = block_size
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
        # host page tier + cluster prefix directory: both are keyed by
        # prefix chunk hashes, so both need the prefix index. host_blocks
        # is one capacity for every replica or a per-replica sequence (the
        # scheduler's host_blocks)
        if host_blocks is None:
            host_blocks = 0
        if np.ndim(host_blocks) == 0:
            host_blocks = [int(host_blocks)] * len(self.replicas)
        else:
            host_blocks = [int(b) for b in host_blocks]
            if len(host_blocks) != len(self.replicas):
                raise ValueError("one host-tier size per replica")
        if (any(host_blocks) or cluster_prefix) and not prefix_caching:
            warnings.warn(
                "host_blocks / cluster_prefix need prefix_caching=True "
                "(the page tiers and the directory are keyed by prefix "
                "chunk hashes); serving without them", stacklevel=2)
            host_blocks = [0] * len(self.replicas)
            cluster_prefix = False
        self.host_blocks = host_blocks
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
        # disaggregated prefill/decode: role-tagged paged replicas + a KV
        # dispatcher wiring prefill workers to decode workers
        if roles is not None and any(r != "both" for r in roles):
            if not paged or len(self.replicas) < 2:
                warnings.warn(
                    "disaggregated roles need policy='continuous' with "
                    "cache_layout='paged' and >= 2 replicas (the KV "
                    "handoff is a page transfer); serving colocated",
                    stacklevel=2)
                roles = None
            elif self.replicas and not context_mode_supported(
                    self.replicas[0].cfg):
                warnings.warn(
                    "disaggregation needs an attention-only stack "
                    "(recurrent running state has no pages to migrate); "
                    "serving colocated", stacklevel=2)
                roles = None
        self.roles = list(roles) if roles is not None \
            else ["both"] * len(self.replicas)
        if len(self.roles) != len(self.replicas):
            raise ValueError("one role per replica")
        # a migrated page payload lands VERBATIM in the destination pool,
        # so a disaggregated group needs one uniform pool precision: the
        # narrowest chosen one wins (the capacity-constrained replica is
        # why precision dropped in the first place)
        if any(r != "both" for r in self.roles):
            chosen = {replica_kv_dtype(i) for i in range(len(self.replicas))}
            if len(chosen) > 1:
                uniform = next((d for d in ("int8", "fp8") if d in chosen),
                               None)
                warnings.warn(
                    "disaggregated replicas must share one KV pool "
                    f"precision (the page payload ships verbatim); using "
                    f"{uniform or 'model default'} everywhere",
                    stacklevel=2)
                kv_dtype, kv_dtypes = uniform, None
        if kvsan and not paged:
            warnings.warn(
                "kvsan sanitizes the paged KV lifecycle; "
                "policy='continuous' with cache_layout='paged' is "
                "required — serving unsanitized", stacklevel=2)
            kvsan = False
        self.dispatcher = None
        if paged:
            self.workers = [PagedPipelineBatcher(
                r, n_slots=n_slots, max_len=max_len,
                block_size=block_size, stage_blocks=stage_blocks,
                prefix_caching=prefix_caching, prefill_chunk=prefill_chunk,
                prefill_token_cost=prefill_token_cost,
                host_blocks=host_blocks[i], host_swap_cost=host_swap_cost,
                virtual_step_cost=sc, role=role, replica_id=i,
                spec=replica_spec(i), kv_dtype=replica_kv_dtype(i),
                kv_guard_layers=kv_guard_layers, kvsan=kvsan)
                for i, (r, role, sc) in enumerate(
                    zip(self.replicas, self.roles, step_costs))]
            self.dispatcher = wire_disaggregation(self.workers, self.roles,
                                                  kv_link)
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
        # tiebreaks, dispatcher targeting, directory residency keys)
        for i, w in enumerate(self.workers):
            w.replica_id = i
        # ---- cluster prefix directory + prefix-aware routing ------------
        self.cluster_dir = None
        if cluster_prefix:
            self.cluster_dir = wire_cluster_prefix(self.workers,
                                                   link=kv_link)
        self.prefix_route_weight = prefix_route_weight
        self.host_route_weight = host_route_weight
        self._route_rng = (np.random.RandomState(route_seed)
                           if route_seed is not None else None)

    # ---- admission dispatch (serving.loop hook) --------------------------
    def _route_key(self, w, now: float):
        # deterministic tiebreak by replica id, or a seeded draw when the
        # caller wants reproducible-but-shuffled routing benchmarks
        tie = (self._route_rng.random() if self._route_rng is not None
               else getattr(w, "replica_id", 0))
        return w.load(now), tie

    def _dispatch(self, cands, req: Request, now: float):
        """Admission choice: least-loaded, minus a prefix-affinity bonus
        when the cluster directory knows a candidate already holds the
        prompt's head. Device-resident blocks count full (an alias costs
        nothing), host-resident ones at ``host_route_weight`` (a swap-in
        is cheaper than recompute but dearer than an alias), and the
        bonus is scaled by ``prefix_route_weight`` into queue-depth
        units — so a deep queue still beats a marginal prefix hit."""
        if self.cluster_dir is None or self.prefix_route_weight <= 0:
            return min(cands, key=lambda w: self._route_key(w, now))
        hashes = chunk_hashes(req.prompt, self.block_size)

        def key(w):
            load, tie = self._route_key(w, now)
            ndev, nhost = self.cluster_dir.resident_blocks(
                hashes, getattr(w, "replica_id", -1))
            bonus = ndev + self.host_route_weight * nhost
            return (load - self.prefix_route_weight * bonus, tie)
        return min(cands, key=key)

    def bind_tracer(self, tracer) -> None:
        """Hand every tracing-aware collaborator the live tracer: workers
        (span emission sites), their proposers (draft instants) and the KV
        dispatcher (migration spans)."""
        for w in self.workers:
            if hasattr(w, "tracer"):
                w.tracer = tracer
            prop = getattr(w, "_proposer", None)
            if prop is not None and hasattr(prop, "tracer"):
                prop.tracer = tracer
        if self.dispatcher is not None:
            self.dispatcher.tracer = tracer

    def serve(self, requests: Sequence[Request], deadline: float, *,
              clock=None, tracer=None, metrics=None) -> ServeStats:
        """Replays a timed workload; wall-clock by default, or any clock
        (VirtualClock for deterministic replay). A ``tracer``
        (repro_torch.obs.trace.Tracer) is bound to every worker for
        lifecycle spans; a ``metrics`` registry
        (repro_torch.obs.metrics.MetricsRegistry) receives per-replica
        counters and pool gauges at the end of the replay."""
        if tracer is not None and tracer.enabled:
            self.bind_tracer(tracer)
        return run_serve_loop(
            self.workers, requests, deadline=deadline,
            clock=clock if clock is not None else WallClock(),
            dispatch=self._dispatch, tracer=tracer, metrics=metrics)
