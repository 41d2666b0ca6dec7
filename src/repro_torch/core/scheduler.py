"""Two-phase HexGen scheduler: public entry point (Contribution 2).

The port's copy of repro.core.scheduler, on the port's config registry
(repro_torch.configs.get_config); nothing is left out.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import get_config
from repro_torch.core import cost_model as cm
from repro_torch.core import genetic
from repro_torch.core.cluster import Cluster
from repro_torch.core.genetic import SearchResult


def schedule(cluster: Cluster, arch: str, task: cm.Task, *,
             deadline: float, rate: float, iters: int = 60,
             seed: int = 0, mutation: str = "hexgen",
             paper_exact: bool = False,
             max_stages: int = 8, kv_block_size=None,
             prefix_hit_rate: float = 0.0,
             disaggregate: bool = False,
             kv_link_gbps: float = 0.0,
             spec_decode: bool = False,
             spec_alpha: float = 0.7,
             spec_draft_cost: float = 0.0,
             max_spec_k: int = 8,
             kv_dtype: Optional[str] = None,
             kv_dtype_search: bool = False,
             host_tier_bytes: float = 0.0,
             host_swap_gbps: float = 0.0,
             prefix_working_set: int = 0,
             cluster_prefix: bool = False) -> SearchResult:
    """Find an assignment of `cluster` serving `arch` replicas.

    deadline: SLO latency bound (s); rate: request rate (req/s).
    mutation="random" reproduces the paper's strawman baseline.
    kv_block_size (None = idealized unbounded replicas) bounds each
    simulated replica's in-flight requests by its KV capacity at that
    paged-block granularity (0 = contiguous rows). prefix_hit_rate is the
    expected fraction of prompt tokens served from the prefix cache
    (serving prefix_caching=True): the capacity bound then plans against
    the effective, DEDUPLICATED per-sequence KV demand.

    disaggregate=True adds the prefill/decode ROLE SPLIT as a search
    dimension: every candidate replica set is also scored under its best
    role assignment (phase-split costs + the SLO simulator's phased
    workers), with the KV handoff modeled over a flat kv_link_gbps link
    (<= 0: the cluster's per-pair best links). The winning split lands in
    SearchResult.roles (None when colocated serving won), aligned with
    assignment.pipelines — pass it to InferenceEngine(roles=...).

    spec_decode=True makes the search ACCEPTANCE-AWARE: every replica is
    scored at its best per-replica speculation depth (cost per COMMITTED
    token given acceptance rate spec_alpha and an absolute
    spec_draft_cost per draft step — cost_model.best_spec_k), so slow
    replicas speculate deeper. The chosen depths land in
    SearchResult.spec_ks, aligned with assignment.pipelines — pass them
    to InferenceEngine(spec_ks=...).

    kv_dtype prices every replica's KV capacity (and the disaggregation
    wire) at that paged-pool storage precision ("int8"/"fp8" pages hold
    ~2-4x the sequences of fp32 in the same memory);
    kv_dtype_search=True instead picks precision PER REPLICA — only the
    memory-bound replicas quantize. The choices land in
    SearchResult.kv_dtypes, aligned with assignment.pipelines — pass
    them to InferenceEngine(kv_dtypes=...).

    host_tier_bytes > 0 sizes a HOST PAGE TIER under the device pools:
    the pool-wide host budget lands on the replicas with the largest
    device KV-capacity deficit (small-HBM GPUs get the big host pools),
    with swap-in/swap-out priced at host_swap_gbps Gbit/s. The per-
    replica capacities land in SearchResult.host_blocks — pass them to
    InferenceEngine(host_blocks=...). prefix_working_set (tokens of hot
    shared prefixes) replaces the static prefix_hit_rate scalar with the
    ACHIEVABLE per-replica rate derived from tiered residency
    (cost_model.effective_prefix_hit_rate); cluster_prefix=True counts
    peer-resident blocks behind the shared directory toward each
    replica's reach, matching serving cluster_prefix=True.
    """
    cfg = get_config(arch)
    profile = cm.ModelProfile.from_config(cfg, paper_exact=paper_exact,
                                          bytes_per_el=task.bytes_per_el)
    res = genetic.search(cluster, profile, task, deadline=deadline,
                         rate=rate, iters=iters, seed=seed,
                         mutation=mutation, max_stages=max_stages,
                         kv_block_size=kv_block_size,
                         prefix_hit_rate=prefix_hit_rate,
                         disaggregate=disaggregate,
                         kv_link_gbps=kv_link_gbps,
                         spec_decode=spec_decode, spec_alpha=spec_alpha,
                         spec_draft_cost=spec_draft_cost,
                         max_spec_k=max_spec_k, kv_dtype=kv_dtype,
                         kv_dtype_search=kv_dtype_search,
                         host_tier_bytes=host_tier_bytes,
                         host_swap_gbps=host_swap_gbps,
                         prefix_working_set=prefix_working_set,
                         cluster_prefix=cluster_prefix)
    res.assignment.validate(cfg.num_layers)
    return res
