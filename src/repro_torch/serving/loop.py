"""The serving loop of the port (copy of repro.serving.loop, line for line
below the imports).

Every serving path — the multi-replica Router and the single-replica
continuous batchers — drives the same event loop with the same admission
policy and the same accounting.
The loop is event-driven at ITERATION granularity: each cycle it (1) admits
due arrivals one at a time onto the least-loaded worker with capacity,
(2) runs one iteration on every busy worker, and (3) when nothing is
runnable, advances the clock to the next event (arrival or completion).

Time is pluggable:

  * ``WallClock``   — real time; idle waits sleep.
  * ``VirtualClock`` — deterministic simulated time; idle waits jump, and
    each worker iteration advances time by the worker's reported cost.
    Identical workload in -> identical ``ServeStats`` out, bit for bit —
    which is how the port is held against the reference engine.

Workers duck-type the replica port:

  capacity(now) -> int        admissible request count right now
  load(now) -> float          least-loaded dispatch key (lower = preferred)
  admit(reqs, now) -> None    hand over requests (may buffer internally)
  busy(now) -> bool           has runnable work at `now`
  run_iteration(now) -> (completions, cost)
                              completions are (request, output | None,
                              finish_time | None) tuples — finish_time None
                              means "stamp with the clock after this
                              iteration"; cost is the virtual-clock advance
  next_event(now) -> float | None
                              earliest future event when idle; None if none
  inflight() -> int           admitted but unfinished request count

A ``tracer`` (repro_torch.obs.trace.Tracer) records the serve, queue-wait
and per-worker iteration spans on this loop's clock, and a ``metrics``
registry (repro_torch.obs.metrics.MetricsRegistry) receives per-replica
counter deltas, engine gauges and the final ServeStats; both only observe.

This file is the one place of the port that reads the wall clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import NULL_TRACER


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------

class WallClock:
    """Monotonic wall time, zeroed at construction. Idle waits sleep."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)

    def tick(self, cost: float) -> None:
        pass                       # real work advanced real time already


class VirtualClock:
    """Deterministic simulated time. Idle waits jump; iterations advance by
    the worker-reported cost."""

    def __init__(self, t0: float = 0.0):
        self._t = t0

    def now(self) -> float:
        return self._t

    def sleep_until(self, t: float) -> None:
        self._t = max(self._t, t)

    def tick(self, cost: float) -> None:
        self._t += cost


# ---------------------------------------------------------------------------
# Accounting — the single ServeStats path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeStats:
    latencies: List[float]
    attainment: float
    throughput: float
    iterations: int = 0            # worker iterations the loop ran
    queue_delays: List[float] = dataclasses.field(default_factory=list)
    rejected: int = 0              # oversized requests turned away
    preemptions: int = 0           # paged slots evicted + recomputed
    dropped: int = 0               # stranded: never finished (no finish_time)
    # prefix-cache counters (PagedPipelineBatcher with prefix_caching=True)
    prefix_lookups: int = 0        # admissions that consulted the index
    prefix_hits: int = 0           # admissions that aliased >= 1 block
    prefix_hit_tokens: int = 0     # prompt tokens served from resident blocks
    prefill_tokens: int = 0        # cold prompt tokens actually prefilled
    cow_copies: int = 0            # shared blocks copied before a write
    # disaggregated prefill/decode (role="prefill" workers, sender side)
    migrations: int = 0            # finished prefills handed to a decoder
    migrated_kv_bytes: int = 0     # KV payload bytes shipped over the link
    # speculative decoding (PagedPipelineBatcher with spec=SpecConfig)
    spec_steps: int = 0            # target multi-token verification steps
    spec_proposed: int = 0         # draft tokens proposed
    spec_accepted: int = 0         # draft tokens the target agreed with
    spec_tokens: int = 0           # tokens committed via verification steps
    # quantized KV pages (PagedPipelineBatcher with kv_dtype="int8"/"fp8")
    kv_bytes_resident: int = 0     # allocated page-pool bytes (+ scales)
    kv_bytes_saved: int = 0        # bytes saved vs model-default pools
    # host page tier (PagedPipelineBatcher with host_blocks > 0)
    host_demotions: int = 0        # blocks spilled device -> host on evict
    host_promotions: int = 0       # blocks swapped back host -> device
    host_evictions: int = 0        # host-tier LRU drops (pages truly lost)
    host_hit_tokens: int = 0       # prompt tokens served from the host tier
    # cluster prefix directory (serving.cluster_kv)
    prefix_fetches: int = 0        # prefix blocks migrated from peer replicas
    prefix_fetched_bytes: int = 0  # payload bytes shipped for those fetches
    # KVSAN runtime sanitizer (PagedPipelineBatcher(kvsan=True))
    kvsan_leaks: int = 0           # pool references no table/index explains
    # total requests this replay accounted (served + rejected + dropped);
    # merge() weights attainment by it
    n_requests: int = 0

    def summary(self) -> str:
        lat = np.asarray(self.latencies)
        if len(lat):
            pct = (f"p50={np.percentile(lat, 50):.3f}s "
                   f"p99={np.percentile(lat, 99):.3f}s ")
        else:                      # zero served (e.g. all rejected/dropped)
            pct = "p50=n/a p99=n/a "
        extra = ""
        if self.prefix_lookups:
            hit = self.prefix_hits / self.prefix_lookups
            extra = (f" hit={hit * 100:.0f}% "
                     f"saved={self.prefix_hit_tokens}tok "
                     f"cow={self.cow_copies}")
        if self.migrations:
            extra += (f" mig={self.migrations} "
                      f"({self.migrated_kv_bytes / 1e6:.2f}MB)")
        if self.spec_steps:
            acc = (self.spec_accepted / self.spec_proposed
                   if self.spec_proposed else 0.0)
            extra += (f" spec={self.spec_tokens}tok"
                      f"/{self.spec_steps}step "
                      f"acc={acc * 100:.0f}%")
        if self.kv_bytes_saved:
            extra += (f" kv={self.kv_bytes_resident / 1e6:.2f}MB "
                      f"(-{self.kv_bytes_saved / 1e6:.2f}MB)")
        if self.host_demotions or self.host_promotions:
            extra += (f" host={self.host_promotions}in/"
                      f"{self.host_demotions}out "
                      f"({self.host_hit_tokens}tok)")
        if self.prefix_fetches:
            extra += (f" fetch={self.prefix_fetches} "
                      f"({self.prefix_fetched_bytes / 1e6:.2f}MB)")
        if self.kvsan_leaks:
            extra += f" KVSAN-LEAKS={self.kvsan_leaks}"
        return (f"n={len(lat)} {pct}"
                f"slo={self.attainment * 100:.1f}% thpt={self.throughput:.2f} req/s "
                f"rej={self.rejected} drop={self.dropped} "
                f"preempt={self.preemptions}{extra}")

    @classmethod
    def from_requests(cls, requests: Sequence, deadline: float,
                      *, iterations: int = 0) -> "ServeStats":
        # three outcomes: SERVED (finished with its tokens), REJECTED
        # (finished with an empty output despite wanting tokens), DROPPED
        # (stranded in the loop, finish_time still None). Latency
        # percentiles and throughput cover served requests only — a
        # rejected request's near-instant turnaround served nobody, and a
        # dropped request has no finish time at all; both count against
        # attainment.
        served = [r for r in requests if r.served]
        dropped = sum(1 for r in requests if r.finish_time is None)
        lats = [r.latency for r in served]

        def attained(r):
            return r.served and r.latency <= deadline
        att = (float(np.mean([attained(r) for r in requests]))
               if requests else 1.0)
        dur = max((r.finish_time for r in served), default=1.0)
        qd = [r.start_time - r.arrival for r in requests
              if r.start_time is not None]
        return cls(latencies=lats, attainment=att,
                   throughput=len(served) / max(dur, 1e-9),
                   iterations=iterations, queue_delays=qd, dropped=dropped,
                   n_requests=len(requests))

    # ---- aggregation across replicas / runs ------------------------------
    @classmethod
    def merge(cls, parts: Sequence["ServeStats"]) -> "ServeStats":
        """Aggregate stats across replicas or runs: integer counters sum,
        percentile inputs (latencies, queue delays) concatenate, SLO
        attainment weights by each part's request count, and throughput
        adds (parts are concurrent replicas of one serve window; for
        sequential runs, recompute from the merged requests instead).
        Degenerate inputs are safe: no parts -> the neutral stats, parts
        with zero requests contribute nothing to attainment."""
        parts = list(parts)
        if not parts:
            return cls(latencies=[], attainment=1.0, throughput=0.0)
        out = cls(latencies=[], attainment=1.0, throughput=0.0)
        for f in dataclasses.fields(cls):
            if f.name in ("latencies", "queue_delays", "attainment",
                          "throughput"):
                continue
            setattr(out, f.name, sum(getattr(p, f.name) for p in parts))
        for p in parts:
            out.latencies.extend(p.latencies)
            out.queue_delays.extend(p.queue_delays)
            out.throughput += p.throughput
        total = sum(p.n_requests for p in parts)
        out.attainment = (sum(p.attainment * p.n_requests for p in parts)
                          / total) if total else 1.0
        return out

    # ---- metrics-registry view (repro_torch.obs.metrics) -----------------
    def publish(self, registry, **labels) -> None:
        """Publish this stats object into a MetricsRegistry: every counter
        field as a ``serve_<name>`` counter, attainment/throughput as
        gauges, and the percentile inputs as histograms. ServeStats stays
        the back-compat summary surface; the registry is the typed
        stream."""
        for f in dataclasses.fields(self):
            if f.name in ("latencies", "queue_delays", "attainment",
                          "throughput"):
                continue
            registry.counter("serve_" + f.name, **labels).inc(
                getattr(self, f.name))
        registry.gauge("serve_attainment", **labels).set(self.attainment)
        registry.gauge("serve_throughput", **labels).set(self.throughput)
        lat = registry.histogram("request_latency_seconds", **labels)
        for v in self.latencies:
            lat.observe(float(v))
        qd = registry.histogram("queue_delay_seconds", **labels)
        for v in self.queue_delays:
            qd.observe(float(v))

    @classmethod
    def from_metrics(cls, registry, **labels) -> "ServeStats":
        """Rebuild a ServeStats view from a registry ``publish`` wrote to.
        Counters and gauges reconstruct exactly; latency/queue-delay
        SAMPLES are approximated by histogram bucket upper bounds (the
        registry keeps distributions, not raw values), so percentiles are
        bucket-resolution estimates."""
        out = cls(latencies=[], attainment=1.0, throughput=0.0)
        for f in dataclasses.fields(cls):
            if f.name in ("latencies", "queue_delays", "attainment",
                          "throughput"):
                continue
            v = registry.value("serve_" + f.name, **labels)
            if v is not None:
                setattr(out, f.name, int(v))
        att = registry.value("serve_attainment", **labels)
        thpt = registry.value("serve_throughput", **labels)
        out.attainment = att if att is not None else 1.0
        out.throughput = thpt if thpt is not None else 0.0

        def _samples(name):
            for ls, h in registry.histograms(name):
                if ls != {k: str(v) for k, v in labels.items()}:
                    continue
                for i, c in enumerate(h.counts):
                    ub = (h.buckets[i] if i < len(h.buckets)
                          else (h.max if h.max is not None else 0.0))
                    yield from [ub] * c
        out.latencies = list(_samples("request_latency_seconds"))
        out.queue_delays = list(_samples("queue_delay_seconds"))
        return out


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def run_serve_loop(workers: Sequence, requests: Sequence, *, deadline: float,
                   clock=None, dispatch=None, tracer=None,
                   metrics=None) -> ServeStats:
    """Replay a timed workload over `workers` and account the outcome.

    Mutates each request in place (`start_time`, `finish_time`, `output`)
    and returns the ServeStats. Dispatch is iteration-level least-loaded
    with a DETERMINISTIC tiebreak (lowest replica id, falling back to
    worker order) so identical workloads route identically run-to-run;
    ``dispatch(cands, req, now) -> worker`` overrides the choice entirely
    (the Router's prefix-aware scoring, seeded tiebreaks).

    ``tracer`` (repro_torch.obs.trace.Tracer) records queue-wait and
    per-worker iteration spans against this loop's clock — pure
    observation, token streams are identical with it on or off.
    ``metrics`` (repro_torch.obs.metrics.MetricsRegistry) receives
    per-replica counter deltas, engine gauges (``metrics_gauges`` port)
    and the final ServeStats publication.
    """
    clock = clock if clock is not None else WallClock()
    tracer = tracer if tracer is not None else NULL_TRACER
    if tracer.enabled:
        tracer.bind_clock(clock)
    pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
    idx = 0
    iterations = 0
    # workers persist across serve() calls: report this replay's deltas.
    counters = ("rejected", "preemptions", "prefix_lookups", "prefix_hits",
                "prefix_hit_tokens", "prefill_tokens", "cow_copies",
                "migrations", "migrated_kv_bytes", "spec_steps",
                "spec_proposed", "spec_accepted", "spec_tokens",
                "kv_bytes_resident", "kv_bytes_saved",
                "host_demotions", "host_promotions", "host_evictions",
                "host_hit_tokens", "prefix_fetches", "prefix_fetched_bytes",
                "kvsan_leaks")
    # MEMBERSHIP IS DYNAMIC: `workers` is consulted live each cycle, so a
    # controller (serving.resched.OnlineRescheduler) removing a dead
    # replica or adding a new one mid-serve is visible next iteration.
    # `seen` retains every worker that EVER served this replay with its
    # counter baseline, so a removed replica's pre-removal work still
    # lands in the final ServeStats instead of vanishing with it.
    wid: dict = {}
    seen: dict = {}

    def _register(ws) -> None:
        for w in ws:
            k = id(w)
            if k not in seen:
                wid[k] = getattr(w, "replica_id", len(wid))
                seen[k] = (w, {c: getattr(w, c, 0) for c in counters})

    _register(workers)
    # serve-level span: the sanctioned begin/end pair (repro-lint
    # span-pairing holds every begin to a matching end on its code path)
    serve_span = tracer.begin("serve") if tracer.enabled else None
    while idx < len(pending) or any(w.inflight() for w in workers):
        now = clock.now()
        _register(workers)         # pick up replicas added last cycle
        progressed = False

        # -- admission: due arrivals onto the least-loaded worker ---------
        while idx < len(pending) and pending[idx].arrival <= now:
            cands = [w for w in workers if w.capacity(now) > 0]
            if not cands:
                break
            req = pending[idx]
            if dispatch is not None:
                w = dispatch(cands, req, now)
            else:
                w = min(cands, key=lambda c: (c.load(now), wid[id(c)]))
            req.start_time = now
            w.admit([req], now)
            if tracer.enabled:
                # queue wait: arrival -> admission, on the chosen replica
                tracer.complete("queue_wait", now - req.arrival,
                                ts=req.arrival, pid=wid[id(w)],
                                rid=req.rid)
            idx += 1
            progressed = True

        # -- one iteration on every busy worker ---------------------------
        # Workers are parallel replicas: in virtual time a cycle costs the
        # SLOWEST busy worker's iteration, not the sum, so the clock ticks
        # once per cycle and completions are stamped after the tick.
        # (snapshot the list: a controller's run_iteration may add or
        # remove replicas, which take effect next cycle)
        max_cost = 0.0
        completed = []
        for w in list(workers):
            if not w.busy(now):
                continue
            done, cost = w.run_iteration(now)
            iterations += 1
            progressed = True
            max_cost = max(max_cost, cost)
            completed.extend(done)
            if tracer.enabled:
                # per-worker iteration span: the clock does not advance
                # DURING an iteration (one tick per cycle, below), so the
                # engine-reported cost is the span's duration
                tracer.complete("iteration", cost, ts=now,
                                pid=wid[id(w)], completions=len(done))
        if max_cost:
            clock.tick(max_cost)
        stamp = clock.now()
        for req, out, when in completed:
            if out is not None:
                req.output = out
            req.finish_time = when if when is not None else stamp

        if progressed:
            continue

        # -- idle: advance the clock to the next FUTURE event -------------
        # (a due-but-unadmittable arrival is not a target: with every
        # worker at zero capacity it cannot progress, and sleeping to a
        # past instant would spin the loop forever — it gets admitted
        # when a worker completion frees capacity)
        targets = []
        if idx < len(pending) and pending[idx].arrival > now:
            targets.append(pending[idx].arrival)
        for w in list(workers):
            t = w.next_event(now)
            if t is not None and t > now:
                targets.append(t)
        if not targets:
            # nothing runnable, nothing scheduled: any request still
            # pending or inflight is STRANDED — it keeps finish_time None
            # and ServeStats reports it as dropped / non-attained instead
            # of a negative latency
            break
        clock.sleep_until(min(targets))

    if serve_span is not None:
        tracer.end(serve_span, requests=len(pending))
    # satellite: with tracing on, the span stream is the source of truth
    # for first_token_time / prefill_finish_time — re-derive them (the
    # values must equal the engines' inline stamps; tests assert it)
    tracer.apply_marks(pending)
    stats = ServeStats.from_requests(pending, deadline,
                                     iterations=iterations)
    for c in counters:
        setattr(stats, c, sum(getattr(w, c, 0) - b[c]
                              for w, b in seen.values()))
    if metrics is not None:
        for w, b in seen.values():
            rep = str(wid[id(w)])
            for c in counters:
                d = getattr(w, c, 0) - b[c]
                if d:
                    metrics.counter("serve_" + c, replica=rep).inc(d)
            gauges = getattr(w, "metrics_gauges", None)
            if gauges is not None:
                for name, lbls, val in gauges():
                    metrics.gauge(name, replica=rep, **lbls).set(val)
        stats.publish(metrics)
    return stats
