"""AlpaServe-style inference workload simulator (§4.3 "Put it together",
§5.1 evaluation metrics).

Requests arrive by a Poisson process (exponential inter-arrival, rate
lambda); each request is dispatched to the replica whose queue admits it
earliest; a replica is a pipeline that admits a new request every
`bottleneck` seconds (stages overlap across requests) and completes it
`latency` seconds after admission. SLO attainment = fraction of requests
finishing within the deadline.

The simulator is the shared serving loop (serving.loop) on a virtual clock,
with each pipeline modeled as a closed-form analytic worker — the SAME
admission policy and accounting that serve real replicas, so simulated and
measured attainment stay comparable by construction.

The port's copy of repro.core.slo_sim, on the port's own serving loop
(serving.loop) and Request; nothing is left out.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.loop import VirtualClock, run_serve_loop
from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class ReplicaModel:
    latency: float        # end-to-end time of one request on this pipeline
    bottleneck: float     # min inter-admission gap (max stage time)
    # in-flight request bound from KV-cache capacity (0 = unbounded, the
    # paper's idealized queue). cost_model.concurrent_capacity derives it
    # for either layout; the paged layout's larger bound — and the further
    # deduplication from prefix caching (prefix_hit_rate) — shows up
    # directly as simulated attainment.
    max_concurrent: int = 0


def poisson_arrivals(rate: float, duration: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > duration:
            break
        ts.append(t)
    return np.asarray(ts)


def piecewise_poisson_arrivals(segments: Sequence[Tuple[float, float]],
                               seed: int = 0) -> np.ndarray:
    """Arrival times of a piecewise-constant-rate Poisson process:
    ``segments`` is a list of (rate, duration) legs played back to back —
    the chaos benchmark's 10x spike is [(r, t0), (10 * r, t1), (r, t2)].
    Rate-0 legs contribute silence."""
    rng = np.random.default_rng(seed)
    ts: List[float] = []
    t0 = 0.0
    for rate, duration in segments:
        assert duration >= 0.0, duration
        if rate > 0.0:
            t = t0
            while True:
                t += rng.exponential(1.0 / rate)
                if t > t0 + duration:
                    break
                ts.append(t)
        t0 += duration
    return np.asarray(ts)


class AnalyticWorker:
    """Closed-form pipeline model as a serve-loop worker: admission every
    `bottleneck` seconds, completion `latency` seconds after admission."""

    def __init__(self, model: ReplicaModel):
        self.model = model
        self.next_admit = 0.0
        self._events: List = []    # heap of (finish_time, order, request)
        self._order = 0

    # ---- replica port (serving.loop) -------------------------------------
    def capacity(self, now: float) -> int:
        if self.model.max_concurrent:
            return max(self.model.max_concurrent - len(self._events), 0)
        return 1 << 30             # unbounded queue, like the paper's sim

    def load(self, now: float) -> float:
        # earliest possible completion for the next admitted request
        return max(self.next_admit, now) + self.model.latency

    def admit(self, reqs, now: float) -> None:
        for r in reqs:
            start = max(self.next_admit, now)
            finish = start + self.model.latency
            self.next_admit = start + self.model.bottleneck
            heapq.heappush(self._events, (finish, self._order, r))
            self._order += 1

    def busy(self, now: float) -> bool:
        return bool(self._events) and self._events[0][0] <= now

    def inflight(self) -> int:
        return len(self._events)

    def next_event(self, now: float):
        return self._events[0][0] if self._events else None

    def run_iteration(self, now: float):
        comps = []
        while self._events and self._events[0][0] <= now:
            finish, _, req = heapq.heappop(self._events)
            comps.append((req, None, finish))
        return comps, 0.0


@dataclasses.dataclass(frozen=True)
class PhasedReplicaModel:
    """A replica with its two inference phases costed separately
    (cost_model.pipeline_phase_costs) — the scheduler's disaggregation
    unit. ``colocated()`` collapses it back into the single-phase
    ReplicaModel: one request costs prefill + decode end to end, and the
    replica turns requests over one combined bottleneck apart."""
    prefill_latency: float
    prefill_bottleneck: float
    decode_latency: float
    decode_bottleneck: float
    max_concurrent: int = 0

    def colocated(self) -> ReplicaModel:
        return ReplicaModel(
            latency=self.prefill_latency + self.decode_latency,
            bottleneck=self.prefill_bottleneck + self.decode_bottleneck,
            max_concurrent=self.max_concurrent)

    def with_spec(self, multiplier: float) -> "PhasedReplicaModel":
        """Speculative decoding makes the worker consume its decode phase
        in MULTI-TOKEN COMMITS: per committed token the replica spends
        ``multiplier`` of its plain per-token decode time (< 1 when
        speculation wins — cost_model.spec_step_cost over the plain step
        cost), so the whole decode phase scales by that factor while
        prefill is untouched. The scaled model feeds the same analytic
        workers; the scheduler picks the per-replica depth behind the
        multiplier (cost_model.best_spec_k via genetic.choose_spec_ks)."""
        assert multiplier > 0.0, multiplier
        return dataclasses.replace(
            self, decode_latency=self.decode_latency * multiplier,
            decode_bottleneck=self.decode_bottleneck * multiplier)


class AnalyticPrefillWorker:
    """Prefill-role analytic replica: admits arrivals at its prefill
    bottleneck cadence, and `prefill_latency` later hands each request to
    the least-loaded decode worker with the modeled transfer delay — no
    completions of its own."""

    def __init__(self, model: PhasedReplicaModel, idx: int):
        self.model = model
        self.idx = idx
        self.targets: List["AnalyticDecodeWorker"] = []   # wired by sim
        self.delay_fn: Callable[[int, int], float] = lambda i, j: 0.0
        self.next_admit = 0.0
        self._events: List = []    # heap of (prefill_done, order, request)
        self._order = 0

    # ---- replica port (serving.loop) -------------------------------------
    def capacity(self, now: float) -> int:
        if self.model.max_concurrent:
            return max(self.model.max_concurrent - len(self._events), 0)
        return 1 << 30

    def load(self, now: float) -> float:
        return max(self.next_admit, now) + self.model.prefill_latency

    def admit(self, reqs, now: float) -> None:
        for r in reqs:
            start = max(self.next_admit, now)
            done = start + self.model.prefill_latency
            self.next_admit = start + self.model.prefill_bottleneck
            heapq.heappush(self._events, (done, self._order, r))
            self._order += 1

    def busy(self, now: float) -> bool:
        return bool(self._events) and self._events[0][0] <= now

    def inflight(self) -> int:
        return len(self._events)

    def next_event(self, now: float):
        return self._events[0][0] if self._events else None

    def run_iteration(self, now: float):
        while self._events and self._events[0][0] <= now:
            done, _, req = heapq.heappop(self._events)
            dst = min(self.targets, key=lambda w: (w.queue_depth(), w.idx))
            req.prefill_finish_time = done
            dst.migrate_in(req, done + self.delay_fn(self.idx, dst.idx))
        return [], 0.0


class AnalyticDecodeWorker:
    """Decode-role analytic replica: admits nothing from the router
    (capacity 0); migrated requests become eligible at their transfer
    arrival time, start decoding at the decode-bottleneck cadence (bounded
    by KV capacity), and complete `decode_latency` after starting."""

    def __init__(self, model: PhasedReplicaModel, idx: int):
        self.model = model
        self.idx = idx
        self.next_admit = 0.0
        self._pending: List = []   # heap of (ready_time, order, request)
        self._events: List = []    # heap of (finish_time, order, request)
        self._order = 0

    # ---- replica port (serving.loop) -------------------------------------
    def capacity(self, now: float) -> int:
        return 0                   # work arrives only via migrate_in

    def load(self, now: float) -> float:
        return max(self.next_admit, now) + self.model.decode_latency

    def queue_depth(self) -> int:
        return len(self._pending) + len(self._events)

    def migrate_in(self, req, ready: float) -> None:
        heapq.heappush(self._pending, (ready, self._order, req))
        self._order += 1

    def _admittable(self, now: float) -> bool:
        if not self._pending or self._pending[0][0] > now:
            return False
        return not self.model.max_concurrent \
            or len(self._events) < self.model.max_concurrent

    def busy(self, now: float) -> bool:
        if self._admittable(now):
            return True
        return bool(self._events) and self._events[0][0] <= now

    def inflight(self) -> int:
        return self.queue_depth()

    def next_event(self, now: float):
        ts = []
        if self._pending:
            ts.append(self._pending[0][0])
        if self._events:
            ts.append(self._events[0][0])
        return min(ts) if ts else None

    def run_iteration(self, now: float):
        while self._admittable(now):
            ready, _, req = heapq.heappop(self._pending)
            start = max(self.next_admit, ready, now)
            finish = start + self.model.decode_latency
            self.next_admit = start + self.model.decode_bottleneck
            heapq.heappush(self._events, (finish, self._order, req))
            self._order += 1
        comps = []
        while self._events and self._events[0][0] <= now:
            finish, _, req = heapq.heappop(self._events)
            comps.append((req, None, finish))
        return comps, 0.0


_EMPTY_PROMPT = np.zeros((0,), np.int32)


def simulate(replicas: Sequence[ReplicaModel], rate: float, deadline: float,
             *, duration: float = 120.0, seed: int = 0) -> float:
    """Returns SLO attainment in [0, 1]."""
    if not replicas:
        return 0.0
    arrivals = poisson_arrivals(rate, duration, seed)
    if len(arrivals) == 0:
        return 1.0
    workers = [AnalyticWorker(rep) for rep in replicas]
    reqs = [Request(rid=i, prompt=_EMPTY_PROMPT, max_new_tokens=0, arrival=t)
            for i, t in enumerate(arrivals)]
    stats = run_serve_loop(workers, reqs, deadline=deadline,
                           clock=VirtualClock())
    return stats.attainment


def simulate_disagg(models: Sequence[PhasedReplicaModel],
                    roles: Sequence[str], rate: float, deadline: float, *,
                    kv_bytes: float = 0.0, link_bw: float = float("inf"),
                    link_lat: float = 0.0,
                    delay_fn: Optional[Callable[[int, int], float]] = None,
                    duration: float = 120.0, seed: int = 0) -> float:
    """SLO attainment of a ROLE-TAGGED replica set on the shared loop:
    "both" replicas serve end to end; "prefill" replicas hand finished
    prefills to the least-loaded "decode" replica after the transfer
    delay (``delay_fn(src, dst)``, defaulting to the flat
    ``link_lat + kv_bytes / link_bw``). Same arrivals, admission policy
    and accounting as ``simulate`` — the colocated and disaggregated
    numbers are comparable by construction."""
    assert len(models) == len(roles)
    if not models:
        return 0.0
    if delay_fn is None:
        flat = link_lat + (kv_bytes / link_bw
                           if np.isfinite(link_bw) else 0.0)
        delay_fn = lambda i, j: flat                          # noqa: E731
    workers = []
    for i, (m, role) in enumerate(zip(models, roles)):
        assert role in ("both", "prefill", "decode"), role
        if role == "both":
            workers.append(AnalyticWorker(m.colocated()))
        elif role == "prefill":
            workers.append(AnalyticPrefillWorker(m, i))
        else:
            workers.append(AnalyticDecodeWorker(m, i))
    prefills = [w for w in workers if isinstance(w, AnalyticPrefillWorker)]
    decodes = [w for w in workers if isinstance(w, AnalyticDecodeWorker)]
    assert bool(prefills) == bool(decodes), \
        f"need both phases covered (or neither): {list(roles)}"
    for w in prefills:
        w.targets = decodes
        w.delay_fn = delay_fn
    arrivals = poisson_arrivals(rate, duration, seed)
    if len(arrivals) == 0:
        return 1.0
    reqs = [Request(rid=i, prompt=_EMPTY_PROMPT, max_new_tokens=0, arrival=t)
            for i, t in enumerate(arrivals)]
    stats = run_serve_loop(workers, reqs, deadline=deadline,
                           clock=VirtualClock())
    return stats.attainment


def attainment_curve(replicas: Sequence[ReplicaModel], rates: Sequence[float],
                     deadline: float, **kw) -> List[float]:
    return [simulate(replicas, r, deadline, **kw) for r in rates]


def min_deadline_for_attainment(replicas: Sequence[ReplicaModel], rate: float,
                                target: float = 0.99, *, duration: float = 120.0,
                                seed: int = 0, hi: float = 1e4) -> float:
    """Smallest deadline achieving `target` attainment (bisection)."""
    lo = 0.0
    hi0 = hi
    if simulate(replicas, rate, hi0, duration=duration, seed=seed) < target:
        return float("inf")
    for _ in range(40):
        mid = (lo + hi) / 2
        if simulate(replicas, rate, mid, duration=duration, seed=seed) >= target:
            hi = mid
        else:
            lo = mid
    return hi


def peak_rate_for_attainment(replicas: Sequence[ReplicaModel],
                             deadline: float, target: float = 0.99, *,
                             duration: float = 120.0, seed: int = 0,
                             hi: float = 64.0) -> float:
    """Largest request rate sustaining `target` attainment (bisection)."""
    if simulate(replicas, 1e-3, deadline, duration=duration, seed=seed) < target:
        return 0.0
    lo = 1e-3
    while simulate(replicas, hi, deadline, duration=duration, seed=seed) >= target:
        hi *= 2
        if hi > 1e5:
            return hi
    for _ in range(30):
        mid = (lo + hi) / 2
        if simulate(replicas, mid, deadline, duration=duration, seed=seed) >= target:
            lo = mid
        else:
            hi = mid
    return lo
