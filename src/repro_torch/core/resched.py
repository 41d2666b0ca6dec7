"""Online rescheduling: drift detection + incremental re-solve + repair.

The genetic search (core.genetic) plans once against a static Task, but
production traffic drifts and replicas die. This module closes the loop
from observed serving statistics back into the scheduler:

- ``DriftDetector`` watches live admission/completion windows (arrival
  rate, prompt-length mix, speculative acceptance, replica liveness) and
  emits a ``DriftSignal`` when the observed workload leaves the band the
  incumbent plan was solved for.
- ``warm_resolve`` re-runs ``genetic.search`` seeded from the incumbent
  ``DeploymentPlan`` projected onto the surviving device pool — a few
  iterations refine an already-good plan instead of a cold search.
- ``repair_plan`` is the fast path for replica death: drop the dead
  replicas and re-pick the disaggregated role split by the Helix-style
  max-flow score (``flow_serve_rate``) over the phase-rate graph — no
  simulation, so it runs in microseconds between serve iterations.

The serving-side executor (serving.resched) diffs the incumbent and the
re-solved ``DeploymentPlan`` and migrates in-flight state; nothing here
touches live slots.

The port's copy of repro.core.resched (it imports nothing of the JAX
package), function for function: for the same seed and inputs every
function returns what the reference's returns.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cluster as cl
from repro_torch.core import cost_model as cm
from repro_torch.core import slo_sim
from repro_torch.core.cluster import Cluster
from repro_torch.core.genetic import Individual, SearchResult, search
from repro_torch.core.plan import DeploymentPlan, ReplicaSpec

# ---------------------------------------------------------------------------
# Drift detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftSignal:
    """One detector firing: why the incumbent plan is suspect.

    kind: "rate_spike" | "mix_shift" | "acceptance_drift" |
    "replica_death" | "model_error"
    factor: observed / planned for the drifted quantity (rate or mean
    prompt length; acceptance reports observed alpha directly;
    model_error reports 1 + mean relative cost-model error).
    observed_rate / observed_prompt_len: the window estimates a re-solve
    should plan against (0 when the window was empty).
    dead: replica keys (device-id frozensets) confirmed dead, if any.
    phase: the worst-calibrated phase, for model_error signals.
    """

    kind: str
    at: float
    factor: float = 1.0
    observed_rate: float = 0.0
    observed_prompt_len: float = 0.0
    observed_alpha: float = 0.0
    dead: Tuple[FrozenSet[int], ...] = ()
    phase: str = ""

    def describe(self) -> str:
        if self.kind == "replica_death":
            return f"replica_death x{len(self.dead)}"
        if self.kind == "model_error" and self.phase:
            return f"model_error factor={self.factor:.2f} " \
                   f"worst={self.phase}"
        return f"{self.kind} factor={self.factor:.2f}"


class DriftDetector:
    """Windowed drift detector over live serving observations.

    The router calls ``observe_admit(now, prompt_len)`` per dispatched
    request and ``observe_spec(proposed, accepted)`` with counter deltas;
    the executor calls ``observe_death(key)`` when a replica dies.
    ``poll(now)`` returns the highest-priority pending ``DriftSignal`` (or
    None) and RE-ANCHORS the fired dimension so one sustained shift
    triggers one re-solve, not one per iteration.

    Thresholds are deliberately coarse: a re-solve costs a warm genetic
    search plus live migrations, so only leave-the-band drift (default 3x
    rate, 2x mean prompt length, alpha off by > 0.25) is worth it.
    """

    def __init__(self, *, rate: float, prompt_len: float = 0.0,
                 spec_alpha: float = 0.0, window: float = 10.0,
                 min_events: int = 8, rate_threshold: float = 3.0,
                 mix_threshold: float = 2.0,
                 alpha_slack: float = 0.25,
                 model_error_threshold: float = 0.5,
                 model_error_min: int = 2):
        assert rate > 0.0, rate
        self.planned_rate = rate
        self.planned_prompt_len = prompt_len
        self.planned_alpha = spec_alpha
        self.window = window
        self.min_events = min_events
        self.rate_threshold = rate_threshold
        self.mix_threshold = mix_threshold
        self.alpha_slack = alpha_slack
        self.model_error_threshold = model_error_threshold
        self.model_error_min = model_error_min
        self._admits: Deque[Tuple[float, int]] = collections.deque()
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._dead: List[FrozenSet[int]] = []
        self._model_errors: List[Tuple[str, float]] = []
        self.signals_fired: List[DriftSignal] = []

    # ---- observations ----------------------------------------------------
    def observe_admit(self, now: float, prompt_len: int) -> None:
        self._admits.append((now, int(prompt_len)))
        self._trim(now)

    def observe_spec(self, proposed: int, accepted: int) -> None:
        self._spec_proposed += int(proposed)
        self._spec_accepted += int(accepted)

    def observe_death(self, key: FrozenSet[int]) -> None:
        if key not in self._dead:
            self._dead.append(frozenset(key))

    def observe_model_error(self, phase: str, predicted: float,
                            observed: float) -> None:
        """One calibration row (repro.obs.calibration.CostCalibrator.feed):
        how far a phase's observed seconds/unit landed from the cost
        model's prediction the incumbent plan was scored with."""
        if predicted > 0.0:
            rel = abs(observed - predicted) / predicted
            self._model_errors.append((phase, rel))

    def _trim(self, now: float) -> None:
        w = self._admits
        while w and w[0][0] < now - self.window:
            w.popleft()

    # ---- window estimates ------------------------------------------------
    def window_rate(self, now: float) -> float:
        self._trim(now)
        if not self._admits:
            return 0.0
        span = max(now - self._admits[0][0], 1e-9)
        return len(self._admits) / span

    def window_prompt_len(self, now: float) -> float:
        self._trim(now)
        if not self._admits:
            return 0.0
        return float(np.mean([n for _, n in self._admits]))

    def window_alpha(self) -> float:
        if self._spec_proposed <= 0:
            return self.planned_alpha
        return self._spec_accepted / self._spec_proposed

    def window_model_error(self) -> float:
        if not self._model_errors:
            return 0.0
        return float(np.mean([e for _, e in self._model_errors]))

    # ---- the trigger -----------------------------------------------------
    def poll(self, now: float) -> Optional[DriftSignal]:
        sig = self._poll(now)
        if sig is not None:
            self.signals_fired.append(sig)
        return sig

    def _poll(self, now: float) -> Optional[DriftSignal]:
        # liveness first: a dead replica is an immediate repair, not a
        # statistics question
        if self._dead:
            dead = tuple(self._dead)
            self._dead.clear()
            return DriftSignal(kind="replica_death", at=now,
                               factor=float(len(dead)), dead=dead,
                               observed_rate=self.window_rate(now),
                               observed_prompt_len=self
                               .window_prompt_len(now))
        if len(self._admits) >= self.min_events:
            rate = self.window_rate(now)
            if rate > 0.0:
                f = rate / self.planned_rate
                if f >= self.rate_threshold \
                        or f <= 1.0 / self.rate_threshold:
                    self.planned_rate = rate      # re-anchor: fire once
                    return DriftSignal(kind="rate_spike", at=now, factor=f,
                                       observed_rate=rate,
                                       observed_prompt_len=self
                                       .window_prompt_len(now))
            plen = self.window_prompt_len(now)
            if self.planned_prompt_len > 0.0 and plen > 0.0:
                f = plen / self.planned_prompt_len
                if f >= self.mix_threshold \
                        or f <= 1.0 / self.mix_threshold:
                    self.planned_prompt_len = plen
                    return DriftSignal(kind="mix_shift", at=now, factor=f,
                                       observed_rate=rate,
                                       observed_prompt_len=plen)
            if self.planned_alpha > 0.0 and self._spec_proposed >= \
                    self.min_events:
                alpha = self.window_alpha()
                if abs(alpha - self.planned_alpha) > self.alpha_slack:
                    base = self.planned_alpha
                    self.planned_alpha = alpha
                    self._spec_proposed = self._spec_accepted = 0
                    return DriftSignal(kind="acceptance_drift", at=now,
                                       factor=alpha / max(base, 1e-9),
                                       observed_rate=rate,
                                       observed_alpha=alpha)
        # calibration drift, lowest priority: the cost model the incumbent
        # plan was scored with no longer matches observed phase costs —
        # traffic may look in-band while every placement score is stale
        if len(self._model_errors) >= self.model_error_min:
            err = self.window_model_error()
            if err > self.model_error_threshold:
                worst = max(self._model_errors, key=lambda pe: pe[1])[0]
                self._model_errors.clear()        # re-anchor: fire once
                return DriftSignal(kind="model_error", at=now,
                                   factor=1.0 + err,
                                   observed_rate=self.window_rate(now),
                                   observed_prompt_len=self
                                   .window_prompt_len(now),
                                   phase=worst)
        return None


# ---------------------------------------------------------------------------
# Helix-style max-flow over the phase-rate graph
# ---------------------------------------------------------------------------

def max_flow(cap: np.ndarray, s: int, t: int) -> float:
    """Edmonds-Karp on a dense capacity matrix (the graphs here have a
    handful of replica nodes, so O(V * E^2) is microseconds)."""
    n = cap.shape[0]
    resid = cap.astype(float).copy()
    flow = 0.0
    while True:
        # BFS for the shortest augmenting path
        parent = np.full(n, -1, dtype=int)
        parent[s] = s
        q: Deque[int] = collections.deque([s])
        while q and parent[t] == -1:
            u = q.popleft()
            for v in range(n):
                if parent[v] == -1 and resid[u, v] > 1e-12:
                    parent[v] = u
                    q.append(v)
        if parent[t] == -1:
            return flow
        # bottleneck along the path
        push = float("inf")
        v = t
        while v != s:
            u = int(parent[v])
            push = min(push, resid[u, v])
            v = u
        v = t
        while v != s:
            u = int(parent[v])
            resid[u, v] -= push
            resid[v, u] += push
            v = u
        flow += push


def flow_serve_rate(prefill_rates: Sequence[float],
                    decode_rates: Sequence[float],
                    link_rates: Optional[np.ndarray] = None) -> float:
    """Sustainable request rate of a disaggregated replica set as the
    max flow source -> prefill nodes -> links -> decode nodes -> sink
    (Helix, PAPERS.md: heterogeneous serving as max-flow over the
    GPU/network graph). Rates are requests/second; ``link_rates[i, j]``
    caps the prefill-i -> decode-j handoff (None = unconstrained wire).
    """
    np_, nd = len(prefill_rates), len(decode_rates)
    if np_ == 0 or nd == 0:
        return 0.0
    # nodes: 0 = source, 1..np_ = prefill, np_+1..np_+nd = decode, last = sink
    n = np_ + nd + 2
    t = n - 1
    cap = np.zeros((n, n))
    for i, r in enumerate(prefill_rates):
        cap[0, 1 + i] = max(float(r), 0.0)
    for j, r in enumerate(decode_rates):
        cap[1 + np_ + j, t] = max(float(r), 0.0)
    for i in range(np_):
        for j in range(nd):
            w = float(link_rates[i, j]) if link_rates is not None \
                else float("inf")
            cap[1 + i, 1 + np_ + j] = max(w, 0.0)
    # inf capacities break the residual arithmetic; clamp to the total
    # achievable flow, which no single edge can exceed
    lim = sum(cap[0, 1:1 + np_])
    cap = np.minimum(cap, lim if lim > 0 else 1.0)
    return max_flow(cap, 0, t)


def colocated_serve_rate(models: Sequence[slo_sim.PhasedReplicaModel]
                         ) -> float:
    """Flow-equivalent score for colocated serving: every replica turns
    requests over its combined bottleneck independently."""
    return sum(1.0 / max(m.prefill_bottleneck + m.decode_bottleneck, 1e-12)
               for m in models)


def phase_rates(models: Sequence[slo_sim.PhasedReplicaModel]
                ) -> Tuple[List[float], List[float]]:
    """Per-replica phase service rates (requests/s) for the flow graph."""
    pre = [1.0 / max(m.prefill_bottleneck, 1e-12) for m in models]
    dec = [1.0 / max(m.decode_bottleneck, 1e-12) for m in models]
    return pre, dec


def flow_role_split(models: Sequence[slo_sim.PhasedReplicaModel], *,
                    kv_bytes: float = 0.0,
                    link_bw: float = float("inf")
                    ) -> Tuple[Optional[List[str]], float]:
    """Fast role repair: pick the prefill/decode split maximizing the
    max-flow serve rate instead of running the SLO simulator. Candidates
    follow the comparative-advantage order genetic.best_role_split uses
    (smallest prefill/decode bottleneck ratio first), plus the colocated
    all-"both" fallback — which wins whenever any split's flow is lower,
    e.g. when every survivor is on one side of the graph.

    Returns (roles, rate); roles is None when colocated wins."""
    n = len(models)
    pre_r, dec_r = phase_rates(models)
    best_roles: Optional[List[str]] = None
    best_rate = colocated_serve_rate(models)
    if n < 2:
        return None, best_rate
    wire = kv_bytes / link_bw if np.isfinite(link_bw) and link_bw > 0 \
        else 0.0
    order = sorted(range(n), key=lambda i: (
        models[i].prefill_bottleneck
        / max(models[i].decode_bottleneck, 1e-12), i))
    for k in range(1, n):
        pre = set(order[:k])
        prates = [pre_r[i] for i in range(n) if i in pre]
        drates = [dec_r[j] for j in range(n) if j not in pre]
        links = None
        if wire > 0.0:
            # one handoff occupies the wire for `wire` seconds
            links = np.full((len(prates), len(drates)), 1.0 / wire)
        rate = flow_serve_rate(prates, drates, links)
        if rate > best_rate:
            best_rate = rate
            best_roles = ["prefill" if i in pre else "decode"
                          for i in range(n)]
    return best_roles, best_rate


# ---------------------------------------------------------------------------
# Fast repair + warm re-solve
# ---------------------------------------------------------------------------

def repair_plan(plan: DeploymentPlan,
                dead: Sequence[FrozenSet[int]], *,
                models: Optional[Sequence[slo_sim.PhasedReplicaModel]]
                = None, kv_bytes: float = 0.0,
                link_bw: float = float("inf")) -> DeploymentPlan:
    """Greedy/flow repair for replica death: drop the dead replicas and,
    if the plan was disaggregated, re-pick the survivors' role split by
    max-flow score (``models`` aligned with the SURVIVING replicas; omit
    them to fall back to all-"both", which is always token-safe).

    This is the fast path the executor takes the instant a replica dies
    — a full warm re-solve can follow asynchronously."""
    gone = {frozenset(k) for k in dead}
    survivors = [r for r in plan.replicas if r.key not in gone]
    dims = plan.dims
    if "roles" in dims and survivors:
        roles: Optional[List[str]] = None
        if models is not None:
            assert len(models) == len(survivors), \
                (len(models), len(survivors))
            roles, _ = flow_role_split(models, kv_bytes=kv_bytes,
                                       link_bw=link_bw)
        if roles is None:
            # colocated fallback: every survivor serves end to end —
            # never leaves prefill-only or decode-only islands behind
            roles = ["both"] * len(survivors)
        survivors = [dataclasses.replace(r, role=roles[i])
                     for i, r in enumerate(survivors)]
    return DeploymentPlan(replicas=survivors, dims=dims).canonical()


def drop_devices(cluster: Cluster, drop: Sequence[int]
                 ) -> Tuple[Cluster, Dict[int, int]]:
    """The surviving pool after ``drop`` device ids die, plus the
    old-id -> new-id map (devices are renumbered contiguously)."""
    dead = set(drop)
    keep = [d for d in cluster.devices if d.id not in dead]
    remap = {d.id: i for i, d in enumerate(keep)}
    devs = [cl.Device(remap[d.id], d.type, d.machine, d.region)
            for d in keep]
    idx = [d.id for d in keep]
    return Cluster(devs, cluster.lat[np.ix_(idx, idx)],
                   cluster.bw[np.ix_(idx, idx)]), remap


def warm_seed(plan: DeploymentPlan, remap: Dict[int, int],
              pool_size: int) -> Individual:
    """The incumbent plan projected onto the surviving pool as a genetic
    individual: each replica's surviving devices stay one group, and
    devices the incumbent never used form one extra group so the search
    can grow into them."""
    groups: List[FrozenSet[int]] = []
    for r in plan.replicas:
        g = frozenset(remap[d] for d in r.device_ids if d in remap)
        if g:
            groups.append(g)
    assigned = {d for g in groups for d in g}
    rest = frozenset(set(range(pool_size)) - assigned)
    if rest:
        groups.append(rest)
    return tuple(sorted(groups, key=lambda g: sorted(g)))


def warm_resolve(cluster: Cluster, model: cm.ModelProfile, task: cm.Task,
                 *, incumbent: DeploymentPlan, deadline: float,
                 rate: float, dead_devices: Sequence[int] = (),
                 iters: int = 8, seed: int = 1,
                 **search_kw) -> Tuple[SearchResult, Dict[int, int]]:
    """Incremental re-solve: project the incumbent onto the pool minus
    ``dead_devices`` and run a SHORT genetic search seeded from it
    (init=[warm]) against the OBSERVED rate/task. Returns the result and
    the old-id -> new-id device map (identity when nothing died) so the
    caller can translate the new plan back into live replica identities.
    """
    if dead_devices:
        pool, remap = drop_devices(cluster, dead_devices)
    else:
        pool, remap = cluster, {d.id: d.id for d in cluster.devices}
    warm = warm_seed(incumbent, remap, len(pool))
    res = search(pool, model, task, deadline=deadline, rate=rate,
                 iters=iters, seed=seed, init=[warm] if warm else None,
                 **search_kw)
    return res, remap
