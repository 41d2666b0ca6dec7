"""§4.3: genetic search over partitions of the device pool into independent
pipeline groups.

Individual = tuple of disjoint device-id frozensets (groups). Each group is
layed out by the Algorithm-1 DP (dp_layout.optimize_pipeline); fitness is the
simulated SLO attainment of the resulting replica set (slo_sim), tie-broken
by mean latency.

Initialization: K-means over the latency-matrix embedding with the elbow
method choosing K (plus machine-per-group and whole-pool seeds). Mutations:
merge / split / swap, with early memory-feasibility pruning of offspring.
A `random` mutation mode reproduces the paper's strawman baseline (Fig. 6).

The port's copy of repro.core.genetic with every search dimension (role
split, speculation depths, KV precision, host tier, cluster prefix): the
port's engine refuses the serving features it does not serve yet, but the
search prices them as the reference does. Nothing is left out.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core import slo_sim
from repro_torch.core.cluster import Cluster
from repro_torch.core.dp_layout import optimize_pipeline
from repro_torch.core.plan import Assignment, DeploymentPlan, PipelinePlan

Individual = Tuple[FrozenSet[int], ...]


def _canon(groups: Sequence[FrozenSet[int]]) -> Individual:
    return tuple(sorted((g for g in groups if g), key=lambda g: sorted(g)))


# ---------------------------------------------------------------------------
# Initialization: K-means over comm topology + elbow
# ---------------------------------------------------------------------------

def _kmeans(feats: np.ndarray, k: int, rng: np.random.Generator,
            iters: int = 20) -> np.ndarray:
    n = len(feats)
    centers = feats[rng.choice(n, size=min(k, n), replace=False)]
    assign = np.zeros(n, dtype=int)
    for _ in range(iters):
        d = ((feats[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for c in range(len(centers)):
            pts = feats[assign == c]
            if len(pts):
                centers[c] = pts.mean(0)
    return assign


def _inertia(feats: np.ndarray, assign: np.ndarray) -> float:
    tot = 0.0
    for c in np.unique(assign):
        pts = feats[assign == c]
        tot += ((pts - pts.mean(0)) ** 2).sum()
    return tot


def kmeans_init(cluster: Cluster, rng: np.random.Generator,
                max_k: int = 12) -> List[Individual]:
    """Elbow-method K-means over the latency matrix rows (footnote: avoids
    slow cross-region links inside one group)."""
    feats = np.log10(cluster.lat + 1e-7)
    ks = range(1, min(max_k, len(cluster)) + 1)
    assigns, inertias = {}, []
    for k in ks:
        a = _kmeans(feats, k, rng)
        assigns[k] = a
        inertias.append(_inertia(feats, a))
    # elbow: max second difference
    if len(inertias) >= 3:
        d2 = np.diff(inertias, 2)
        k_star = int(np.argmax(d2)) + 2
    else:
        k_star = 1
    seeds = []
    for k in {k_star, max(1, k_star - 1), min(len(ks), k_star + 1)}:
        a = assigns[k]
        groups = [frozenset(np.flatnonzero(a == c).tolist())
                  for c in np.unique(a)]
        seeds.append(_canon(groups))
    # machine-per-group seed
    seeds.append(_canon([frozenset(ids) for ids in
                         cluster.machines().values()]))
    # whole pool
    seeds.append(_canon([frozenset(range(len(cluster)))]))
    return list(dict.fromkeys(seeds))


# ---------------------------------------------------------------------------
# Mutations (§4.3)
# ---------------------------------------------------------------------------

def mutate(ind: Individual, rng: np.random.Generator) -> Individual:
    groups = [set(g) for g in ind]
    op = rng.choice(["merge", "split", "swap"])
    if op == "merge" and len(groups) >= 2:
        i, j = rng.choice(len(groups), size=2, replace=False)
        groups[i] |= groups[j]
        del groups[j]
    elif op == "split" and groups:
        i = int(rng.integers(len(groups)))
        g = sorted(groups[i])
        if len(g) >= 2:
            # even split per the tau-vector definition
            a, b = set(g[0::2]), set(g[1::2])
            groups[i] = a
            groups.append(b)
    elif op == "swap" and len(groups) >= 2:
        i, j = rng.choice(len(groups), size=2, replace=False)
        if groups[i]:
            d = int(rng.choice(sorted(groups[i])))
            groups[i].discard(d)
            groups[j].add(d)
    return _canon([frozenset(g) for g in groups])


def mutate_random(ind: Individual, rng: np.random.Generator) -> Individual:
    """Strawman baseline: randomly reassign a few devices between groups."""
    groups = [set(g) for g in ind]
    if not groups:
        return ind
    for _ in range(int(rng.integers(1, 4))):
        all_devs = [d for g in groups for d in g]
        d = int(rng.choice(all_devs))
        for g in groups:
            g.discard(d)
        k = int(rng.integers(len(groups) + 1))
        if k == len(groups):
            groups.append({d})
        else:
            groups[k].add(d)
    return _canon([frozenset(g) for g in groups])


# ---------------------------------------------------------------------------
# Fitness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchResult:
    """What the search found: a DeploymentPlan plus search telemetry.

    The per-replica decisions (disaggregated role, speculation depth, KV
    pool precision, host-tier blocks) live on ``plan.replicas`` — one
    ``ReplicaSpec`` each — instead of the parallel Optional lists earlier
    releases carried. The old field names (``roles``, ``spec_ks``,
    ``kv_dtypes``, ``host_blocks``) remain as deprecated properties with
    identical semantics (None when the search ran without that
    dimension) for one release; new code should read ``result.plan``.
    """

    plan: DeploymentPlan
    attainment: float
    history: List[Tuple[float, float]]    # (wall_seconds, best_attainment)
    evaluations: int

    @property
    def assignment(self) -> Assignment:
        return self.plan.assignment

    @staticmethod
    def _deprecated(name: str) -> None:
        warnings.warn(
            f"SearchResult.{name} is deprecated; read the per-replica "
            f"values from SearchResult.plan.replicas (or the "
            f"DeploymentPlan.{name} view) instead",
            DeprecationWarning, stacklevel=3)

    @property
    def roles(self) -> Optional[List[str]]:
        self._deprecated("roles")
        return self.plan.roles

    @property
    def spec_ks(self) -> Optional[List[int]]:
        self._deprecated("spec_ks")
        return self.plan.spec_ks

    @property
    def kv_dtypes(self) -> Optional[List[Optional[str]]]:
        self._deprecated("kv_dtypes")
        return self.plan.kv_dtypes

    @property
    def host_blocks(self) -> Optional[List[int]]:
        self._deprecated("host_blocks")
        return self.plan.host_blocks


def choose_kv_dtypes(plans: Sequence[PipelinePlan],
                     capacity_at, *, rate: float
                     ) -> List[Optional[str]]:
    """The precision dimension of the search: per replica, keep the pool
    at model precision unless its KV capacity cannot hold its share of
    the in-flight demand, in which case quantize to int8 pages (~2-4x
    the sequences in the same memory, cost_model.kv_dtype_bytes_per_el).

    ``capacity_at(plan, kv_dtype)`` returns the replica's concurrent-
    sequence bound at a candidate precision. Demand is Little's law:
    rate/N arrivals/s held for the replica's end-to-end latency each.
    Quantization costs accuracy (bounded, but nonzero), so a replica
    that FITS at full precision stays there — only the memory-bound
    ones trade precision for capacity."""
    n = max(len(plans), 1)
    out: List[Optional[str]] = []
    for p in plans:
        need = rate / n * p.cost
        cap = capacity_at(p, None)
        out.append(None if cap >= need else "int8")
    return out


def choose_host_tiers(plans: Sequence[PipelinePlan], capacity_at, *,
                      rate: float, blocks_per_seq: int,
                      budget_blocks: int) -> List[int]:
    """The host-tier dimension of the search: split a pool-wide host-page
    budget across replicas proportionally to their device KV-capacity
    DEFICIT, so the small-HBM replicas — the ones whose device pools run
    dry and demote hardest — get the large host pools.

    ``capacity_at(plan)`` is the replica's device-tier concurrent-sequence
    bound; its Little's-law demand is rate/N arrivals/s held for the
    replica's end-to-end latency each. The shortfall, times
    ``blocks_per_seq``, is the replica's host demand in blocks. A pool
    with no deficit anywhere still churns prefixes under eviction, so an
    all-feasible replica set splits the budget evenly instead of
    discarding it."""
    n = len(plans)
    if n == 0 or budget_blocks <= 0:
        return [0] * n
    deficits = []
    for p in plans:
        need = rate / n * p.cost
        cap = capacity_at(p)
        deficits.append(max(0.0, need - cap) * max(blocks_per_seq, 1))
    total = sum(deficits)
    if total <= 0:
        base, extra = divmod(budget_blocks, n)
        return [base + (1 if i < extra else 0) for i in range(n)]
    return [int(budget_blocks * d / total) for d in deficits]


def choose_spec_ks(models: Sequence[slo_sim.PhasedReplicaModel], *,
                   alpha: float, draft_step_cost: float, s_out: int,
                   max_k: int = 8) -> Tuple[List[int], List[float]]:
    """The acceptance-aware speculation dimension: per replica, pick the
    depth k minimizing decode time per COMMITTED token
    (cost_model.best_spec_k) and return (ks, decode multipliers).

    A replica's decode STEP time is its decode bottleneck per generated
    token; the draft cost is absolute, so SLOW replicas amortize each
    draft over a bigger saved step and speculate DEEPER — exactly the
    heterogeneity lever: the laggard stage that paces the whole pool is
    the one multi-token commits help most. The multipliers feed
    ``PhasedReplicaModel.with_spec`` so the SLO simulator's workers
    consume decode in multi-token commits."""
    ks: List[int] = []
    mults: List[float] = []
    for m in models:
        step = m.decode_bottleneck / max(s_out, 1)
        if step <= 0.0:
            ks.append(0)
            mults.append(1.0)
            continue
        k = cm.best_spec_k(step, draft_step_cost, alpha, max_k=max_k)
        ks.append(k)
        mults.append(cm.spec_step_cost(step, draft_step_cost, alpha, k)
                     / step)
    return ks, mults


def best_role_split(models: Sequence[slo_sim.PhasedReplicaModel], *,
                    rate: float, deadline: float, kv_bytes: float = 0.0,
                    link_bw: float = float("inf"), link_lat: float = 0.0,
                    delay_fn=None, duration: float = 60.0, seed: int = 0
                    ) -> Tuple[Optional[List[str]], float]:
    """The disaggregation search dimension: split N replicas into prefill
    and decode roles, scored by the SLO simulator.

    Candidate prefill replicas are taken in order of comparative
    advantage (smallest prefill/decode bottleneck ratio first — the
    compute-rich replicas); every prefill-count k in [1, N) is simulated
    and the best attainment wins. Ties keep the SMALLEST k: decode
    replicas hold KV for a request's whole lifetime, so spare capacity
    belongs on the decode side. Returns (roles, attainment); (None, 0.0)
    when fewer than two replicas exist."""
    n = len(models)
    if n < 2:
        return None, 0.0
    order = sorted(range(n), key=lambda i: (
        models[i].prefill_bottleneck
        / max(models[i].decode_bottleneck, 1e-12), i))
    best_roles: Optional[List[str]] = None
    best_att = -1.0
    for k in range(1, n):
        pre = set(order[:k])
        roles = ["prefill" if i in pre else "decode" for i in range(n)]
        att = slo_sim.simulate_disagg(
            models, roles, rate, deadline, kv_bytes=kv_bytes,
            link_bw=link_bw, link_lat=link_lat, delay_fn=delay_fn,
            duration=duration, seed=seed)
        if att > best_att:
            best_roles, best_att = roles, att
    return best_roles, best_att


class Evaluator:
    def __init__(self, cluster: Cluster, model: cm.ModelProfile,
                 task: cm.Task, *, deadline: float, rate: float,
                 sim_duration: float = 60.0, seed: int = 0,
                 max_stages: int = 8, kv_block_size: Optional[int] = None,
                 prefix_hit_rate: float = 0.0,
                 disaggregate: bool = False, kv_link_gbps: float = 0.0,
                 spec_decode: bool = False, spec_alpha: float = 0.7,
                 spec_draft_cost: float = 0.0, max_spec_k: int = 8,
                 kv_dtype: Optional[str] = None,
                 kv_dtype_search: bool = False,
                 host_tier_bytes: float = 0.0,
                 host_swap_gbps: float = 0.0,
                 prefix_working_set: int = 0,
                 cluster_prefix: bool = False):
        self.cluster = cluster
        self.model = model
        self.task = task
        self.deadline = deadline
        self.rate = rate
        self.sim_duration = sim_duration
        self.seed = seed
        self.max_stages = max_stages
        # None -> idealized unbounded replicas (the paper's sim); an int
        # bounds each replica's in-flight requests by its KV capacity at
        # that block granularity (0 = contiguous rows), so paged capacity
        # shows up in simulated attainment. prefix_hit_rate further
        # deduplicates the planned per-sequence KV demand (shared prompt
        # blocks are resident once, serving.block_manager.PrefixIndex).
        self.kv_block_size = kv_block_size
        self.prefix_hit_rate = prefix_hit_rate
        # disaggregated serving: score each individual colocated AND under
        # its best prefill/decode role split (best_role_split); the KV
        # transfer is kv_bytes over a flat kv_link_gbps link, or over the
        # cluster's per-pair best links when kv_link_gbps <= 0
        self.disaggregate = disaggregate
        self.kv_link_gbps = kv_link_gbps
        # acceptance-aware speculative decoding: score each replica with
        # its best per-replica speculation depth (choose_spec_ks) at the
        # expected acceptance rate spec_alpha, charging spec_draft_cost
        # seconds per draft step
        self.spec_decode = spec_decode
        self.spec_alpha = spec_alpha
        self.spec_draft_cost = spec_draft_cost
        self.max_spec_k = max_spec_k
        # quantized KV pages: kv_dtype fixes ONE pool precision for every
        # replica (None = model default); kv_dtype_search instead picks
        # precision PER REPLICA (choose_kv_dtypes) — memory-bound replicas
        # quantize, the rest stay at model precision
        self.kv_dtype = kv_dtype
        self.kv_dtype_search = kv_dtype_search
        # host page tier + cluster prefix directory: host_tier_bytes is a
        # POOL-WIDE host-memory budget split across replicas by KV-capacity
        # deficit (choose_host_tiers -> SearchResult.host_blocks);
        # host_swap_gbps prices the swap/fetch link (<= 0 = free), and
        # prefix_working_set (tokens of hot shared prefixes) turns the
        # static prefix_hit_rate scalar into a residency-derived
        # ACHIEVABLE rate (cost_model.effective_prefix_hit_rate).
        # cluster_prefix lets every replica reach the others' resident
        # blocks through the shared directory (serving.cluster_kv).
        self.host_tier_bytes = host_tier_bytes
        self.host_swap_gbps = host_swap_gbps
        self.prefix_working_set = prefix_working_set
        self.cluster_prefix = cluster_prefix
        self._plan_cache: Dict[FrozenSet[int], Optional[PipelinePlan]] = {}
        self._fit_cache: Dict[Individual, Tuple[float, float]] = {}
        self._roles_cache: Dict[Individual, Optional[List[str]]] = {}
        self._spec_cache: Dict[Individual, Optional[List[int]]] = {}
        self._kvd_cache: Dict[Individual,
                              Optional[List[Optional[str]]]] = {}
        self._host_cache: Dict[Individual, Optional[List[int]]] = {}
        self.evaluations = 0

    def _feasible(self, group: FrozenSet[int]) -> bool:
        """Early check (§4.3): group memory must hold one model copy."""
        total = sum(self.cluster.devices[d].spec.mem_bytes for d in group)
        need = self.model.params_per_layer * self.model.num_layers \
            * self.task.bytes_per_el
        return total >= need

    def plan(self, group: FrozenSet[int]) -> Optional[PipelinePlan]:
        if group not in self._plan_cache:
            if not self._feasible(group):
                self._plan_cache[group] = None
            else:
                self._plan_cache[group] = optimize_pipeline(
                    self.cluster, sorted(group), self.model, self.task,
                    max_stages=self.max_stages)
        return self._plan_cache[group]

    def assignment(self, ind: Individual) -> Assignment:
        plans = [self.plan(g) for g in ind]
        return Assignment([p for p in plans if p is not None])

    def _max_concurrent(self, plan: PipelinePlan,
                        kv_dtype: Optional[str] = "__default__",
                        hit_rate: Optional[float] = None) -> int:
        """KV-capacity bound of one replica: the tightest stage's
        concurrent-sequence count at the configured block granularity
        (0 when capacity is idealized as unbounded) and pool precision
        (the evaluator-wide kv_dtype unless overridden per replica).
        ``hit_rate`` overrides the static prefix_hit_rate scalar with the
        residency-derived per-replica rate."""
        if self.kv_block_size is None:
            return 0
        if kv_dtype == "__default__":
            kv_dtype = self.kv_dtype
        if hit_rate is None:
            hit_rate = self.prefix_hit_rate
        return min(cm.concurrent_capacity(
            self.cluster, st.device_ids, st.num_layers, self.model,
            self.task, block_size=self.kv_block_size,
            prefix_hit_rate=hit_rate, kv_dtype=kv_dtype)
            for st in plan.stages)

    def _phase_model(self, plan: PipelinePlan,
                     kv_dtype: Optional[str] = "__default__",
                     hit_rate: Optional[float] = None
                     ) -> slo_sim.PhasedReplicaModel:
        stages = [st.device_ids for st in plan.stages]
        pc = cm.pipeline_phase_costs(self.cluster, stages, plan.layer_split,
                                     self.model, self.task)
        return slo_sim.PhasedReplicaModel(
            prefill_latency=pc.prefill_latency,
            prefill_bottleneck=pc.prefill_bottleneck,
            decode_latency=pc.decode_latency,
            decode_bottleneck=pc.decode_bottleneck,
            max_concurrent=self._max_concurrent(plan, kv_dtype, hit_rate))

    def _replica_hit_rates(self, plans: Sequence[PipelinePlan],
                           host_blocks: Optional[List[int]],
                           kv_dtypes: Optional[List[Optional[str]]]
                           ) -> Optional[List[float]]:
        """Residency-derived per-replica prefix hit rates replacing the
        static scalar: each replica's reach is its device pool blocks +
        its host tier + (cluster_prefix) every peer's resident blocks,
        tier blocks discounted by swap-vs-recompute time. None when no
        working set was given (the static scalar stands)."""
        bs = self.kv_block_size
        if self.prefix_working_set <= 0 or not bs or not plans:
            return None
        ws = -(-self.prefix_working_set // bs)

        def kvd(i):
            return kv_dtypes[i] if kv_dtypes is not None else self.kv_dtype

        hb = host_blocks if host_blocks is not None else [0] * len(plans)
        dev, disc = [], []
        for i, p in enumerate(plans):
            dev.append(min(cm.device_pool_blocks(
                self.cluster, st.device_ids, st.num_layers, self.model,
                self.task, bs, kv_dtype=kvd(i)) for st in p.stages))
            if self.host_swap_gbps > 0:
                swap = cm.host_swap_seconds_per_block(
                    self.model, self.task, bs, self.host_swap_gbps,
                    kv_dtype=kvd(i))
                pc = cm.pipeline_phase_costs(
                    self.cluster, [st.device_ids for st in p.stages],
                    [st.num_layers for st in p.stages], self.model,
                    self.task)
                recompute = pc.prefill_latency / max(self.task.s_in, 1) * bs
                disc.append(min(1.0, swap / recompute)
                            if recompute > 0 else 1.0)
            else:
                disc.append(0.0)
        reach = [dev[i] + hb[i] for i in range(len(plans))]
        out = []
        for i in range(len(plans)):
            peers = sum(reach) - reach[i] if self.cluster_prefix else 0
            out.append(cm.effective_prefix_hit_rate(
                self.prefix_hit_rate, working_set_blocks=ws,
                device_blocks=dev[i], host_blocks=hb[i],
                peer_blocks=peers, tier_discount=disc[i]))
        return out

    def _pair_delay_fn(self, plans: List[PipelinePlan], kv_bytes: float):
        """Per-pair transfer delay over the cluster's best link from the
        source pipeline's LAST stage to the destination's FIRST."""
        def delay(i: int, j: int) -> float:
            best = min((float(self.cluster.lat[a, b])
                        + kv_bytes / float(self.cluster.bw[a, b]))
                       for a in plans[i].stages[-1].device_ids
                       for b in plans[j].stages[0].device_ids)
            return best
        return delay

    def roles_for(self, ind: Individual) -> Optional[List[str]]:
        """The role split fitness() chose for `ind` (None = colocated)."""
        self.fitness(ind)
        return self._roles_cache[ind]

    def spec_ks_for(self, ind: Individual) -> Optional[List[int]]:
        """The per-replica speculation depths fitness() chose for `ind`
        (None = search ran without spec_decode)."""
        self.fitness(ind)
        return self._spec_cache[ind]

    def kv_dtypes_for(self, ind: Individual
                      ) -> Optional[List[Optional[str]]]:
        """The per-replica pool precisions fitness() chose for `ind`
        (None = search ran without kv_dtype_search)."""
        self.fitness(ind)
        return self._kvd_cache[ind]

    def host_blocks_for(self, ind: Individual) -> Optional[List[int]]:
        """The per-replica host-tier capacities (blocks) fitness() chose
        for `ind` (None = search ran without host_tier_bytes)."""
        self.fitness(ind)
        return self._host_cache[ind]

    def fitness(self, ind: Individual) -> Tuple[float, float]:
        """(SLO attainment, -mean latency) to maximize lexicographically.
        With disaggregate=True the attainment is the better of colocated
        serving and the best prefill/decode role split; with
        spec_decode=True every replica is scored at its acceptance-aware
        best speculation depth (multi-token decode commits)."""
        if ind in self._fit_cache:
            return self._fit_cache[ind]
        self.evaluations += 1
        asg = self.assignment(ind)
        # precision per replica: memory-bound replicas quantize to int8
        # pages, the rest keep the model default (choose_kv_dtypes)
        kv_dtypes = None
        if self.kv_dtype_search and self.kv_block_size is not None \
                and asg.pipelines:
            kv_dtypes = choose_kv_dtypes(
                asg.pipelines,
                lambda p, kvd: self._max_concurrent(p, kvd),
                rate=self.rate)

        def kvd(i: int) -> Optional[str]:
            return kv_dtypes[i] if kv_dtypes is not None else self.kv_dtype

        # host tier: split the pool-wide host budget by device-capacity
        # deficit (small-HBM replicas get the big pools), then derive the
        # per-replica ACHIEVABLE prefix hit rate from total residency
        host_blocks = None
        if self.host_tier_bytes > 0 and self.kv_block_size \
                and asg.pipelines:
            budget = cm.host_tier_blocks(
                self.host_tier_bytes, self.model, self.task,
                self.kv_block_size, kv_dtype=self.kv_dtype)
            bps = -(-(self.task.s_in + self.task.s_out)
                    // self.kv_block_size)
            host_blocks = choose_host_tiers(
                asg.pipelines,
                lambda p: self._max_concurrent(p),
                rate=self.rate, blocks_per_seq=bps, budget_blocks=budget)
        hit_rates = self._replica_hit_rates(asg.pipelines, host_blocks,
                                            kv_dtypes)

        def hr(i: int) -> Optional[float]:
            return hit_rates[i] if hit_rates is not None else None

        models = None
        spec_ks = None
        if (self.spec_decode or self.disaggregate) and asg.pipelines:
            models = [self._phase_model(p, kvd(i), hr(i))
                      for i, p in enumerate(asg.pipelines)]
        if self.spec_decode and models:
            spec_ks, mults = choose_spec_ks(
                models, alpha=self.spec_alpha,
                draft_step_cost=self.spec_draft_cost,
                s_out=self.task.s_out, max_k=self.max_spec_k)
            models = [m.with_spec(u) for m, u in zip(models, mults)]
            # colocated scoring through the phase-split model so the
            # multiplier shaves exactly the decode share of the cost
            reps = [m.colocated() for m in models]
        else:
            reps = [slo_sim.ReplicaModel(
                p.cost, p.bottleneck,
                max_concurrent=self._max_concurrent(p, kvd(i), hr(i)))
                for i, p in enumerate(asg.pipelines)]
        att = slo_sim.simulate(reps, self.rate, self.deadline,
                               duration=self.sim_duration, seed=self.seed)
        roles = None
        if self.disaggregate and len(asg.pipelines) >= 2:
            # migration ships the CACHE dtype over the link; with per-
            # replica search the wire runs at the quantized width as soon
            # as any replica quantized (the serving layer coerces one
            # uniform pool dtype across a disaggregated group)
            wire_kvd = self.kv_dtype
            if kv_dtypes is not None and any(kv_dtypes):
                wire_kvd = next(d for d in kv_dtypes if d)
            kv_bytes = cm.kv_migration_bytes(self.model, self.task,
                                             self.kv_block_size or 0,
                                             kv_dtype=wire_kvd)
            if self.kv_link_gbps > 0:
                kw = dict(kv_bytes=kv_bytes,
                          link_bw=self.kv_link_gbps * 1e9 / 8)
            else:
                kw = dict(delay_fn=self._pair_delay_fn(asg.pipelines,
                                                       kv_bytes))
            d_roles, d_att = best_role_split(
                models, rate=self.rate, deadline=self.deadline,
                duration=self.sim_duration, seed=self.seed, **kw)
            if d_roles is not None and d_att > att:
                att, roles = d_att, d_roles
        self._roles_cache[ind] = roles
        self._spec_cache[ind] = spec_ks
        self._kvd_cache[ind] = kv_dtypes
        self._host_cache[ind] = host_blocks
        mean_lat = np.mean([p.cost for p in asg.pipelines]) if asg.pipelines \
            else float("inf")
        out = (att, -mean_lat)
        self._fit_cache[ind] = out
        return out


def search(cluster: Cluster, model: cm.ModelProfile, task: cm.Task, *,
           deadline: float, rate: float, iters: int = 60,
           pop_size: int = 10, seed: int = 0, mutation: str = "hexgen",
           sim_duration: float = 60.0, max_stages: int = 8,
           kv_block_size: Optional[int] = None,
           prefix_hit_rate: float = 0.0,
           disaggregate: bool = False, kv_link_gbps: float = 0.0,
           spec_decode: bool = False, spec_alpha: float = 0.7,
           spec_draft_cost: float = 0.0, max_spec_k: int = 8,
           kv_dtype: Optional[str] = None, kv_dtype_search: bool = False,
           host_tier_bytes: float = 0.0, host_swap_gbps: float = 0.0,
           prefix_working_set: int = 0, cluster_prefix: bool = False,
           init: Optional[List[Individual]] = None) -> SearchResult:
    """The full two-phase search: genetic over partitions, DP inside.
    disaggregate=True adds the prefill/decode role split as a scored
    search dimension (SearchResult.roles); spec_decode=True scores every
    replica at its acceptance-aware best speculation depth
    (SearchResult.spec_ks — slow replicas speculate deeper);
    kv_dtype fixes one pool precision for every replica, while
    kv_dtype_search=True picks precision PER REPLICA instead
    (SearchResult.kv_dtypes — memory-bound replicas quantize).

    host_tier_bytes > 0 adds the HOST PAGE TIER dimension: the pool-wide
    host budget is split across replicas by device KV-capacity deficit
    (SearchResult.host_blocks — small-HBM replicas get the big pools),
    with swaps priced at host_swap_gbps. prefix_working_set (tokens of
    hot shared prefixes) replaces the static prefix_hit_rate scalar with
    a residency-derived achievable rate per replica; cluster_prefix=True
    counts peer-resident blocks behind the shared directory toward each
    replica's reach (serving.cluster_kv)."""
    rng = np.random.default_rng(seed)
    ev = Evaluator(cluster, model, task, deadline=deadline, rate=rate,
                   sim_duration=sim_duration, seed=seed,
                   max_stages=max_stages, kv_block_size=kv_block_size,
                   prefix_hit_rate=prefix_hit_rate,
                   disaggregate=disaggregate, kv_link_gbps=kv_link_gbps,
                   spec_decode=spec_decode, spec_alpha=spec_alpha,
                   spec_draft_cost=spec_draft_cost, max_spec_k=max_spec_k,
                   kv_dtype=kv_dtype, kv_dtype_search=kv_dtype_search,
                   host_tier_bytes=host_tier_bytes,
                   host_swap_gbps=host_swap_gbps,
                   prefix_working_set=prefix_working_set,
                   cluster_prefix=cluster_prefix)
    if init is None:
        if mutation == "hexgen":
            pop = kmeans_init(cluster, rng)
        else:
            # strawman: random partitions
            pop = []
            for _ in range(4):
                k = int(rng.integers(1, max(2, len(cluster) // 4)))
                a = rng.integers(0, k, size=len(cluster))
                pop.append(_canon([frozenset(np.flatnonzero(a == c).tolist())
                                   for c in range(k)]))
    else:
        pop = list(init)
    mut = mutate if mutation == "hexgen" else mutate_random

    # offline scheduler-search profiling, not serving-path time: the
    # anytime-curve `history` records real search wall time by design
    t0 = time.monotonic()             # repro: noqa[clock-discipline]
    scored = sorted(((ev.fitness(i), i) for i in pop), reverse=True)
    history = [(time.monotonic() - t0, scored[0][0][0])]  # repro: noqa[clock-discipline]
    for _ in range(iters):
        # sample parents biased to the best
        parents = [i for _, i in scored[:max(2, pop_size // 2)]]
        children = []
        for p in parents:
            child = mut(p, rng)
            if mutation == "hexgen":
                # early feasibility pruning of offspring groups
                if not any(ev._feasible(g) for g in child):
                    continue
            children.append(child)
        allc = {i for _, i in scored} | set(children)
        scored = sorted(((ev.fitness(i), i) for i in allc), reverse=True)
        scored = scored[:pop_size]
        history.append((time.monotonic() - t0, scored[0][0][0]))  # repro: noqa[clock-discipline]
    best = scored[0][1]
    asg = ev.assignment(best)
    plan = DeploymentPlan.from_search(asg, roles=ev.roles_for(best),
                                      spec_ks=ev.spec_ks_for(best),
                                      kv_dtypes=ev.kv_dtypes_for(best),
                                      host_blocks=ev.host_blocks_for(best))
    return SearchResult(plan=plan, attainment=scored[0][0][0],
                        history=history, evaluations=ev.evaluations)
