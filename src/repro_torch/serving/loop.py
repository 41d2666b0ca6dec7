"""The serving loop of the port (copy of repro.serving.loop, with its
``dispatch`` hook, without its tracing and metrics hooks, which wait for a
later slice).

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

This file is the one place of the port that reads the wall clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np


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

# engine counters the loop reports as per-replay deltas
COUNTERS = ("rejected", "preemptions", "prefix_lookups", "prefix_hits",
            "prefix_hit_tokens", "prefill_tokens", "cow_copies",
            "spec_steps", "spec_proposed", "spec_accepted", "spec_tokens",
            "kv_bytes_resident", "kv_bytes_saved")


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
    # speculative decoding (PagedPipelineBatcher with spec=SpecConfig)
    spec_steps: int = 0            # target multi-token verification steps
    spec_proposed: int = 0         # draft tokens proposed
    spec_accepted: int = 0         # draft tokens the target agreed with
    spec_tokens: int = 0           # tokens committed via verification steps
    # page-pool bytes (PagedPipelineBatcher; quantized with kv_dtype=
    # "int8" / "fp8")
    kv_bytes_resident: int = 0     # allocated page-pool bytes (+ scales)
    kv_bytes_saved: int = 0        # bytes saved vs model-default pools
    # total requests this replay accounted (served + rejected + dropped)
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
        if self.spec_steps:
            acc = (self.spec_accepted / self.spec_proposed
                   if self.spec_proposed else 0.0)
            extra += (f" spec={self.spec_tokens}tok"
                      f"/{self.spec_steps}step "
                      f"acc={acc * 100:.0f}%")
        if self.kv_bytes_saved:
            extra += (f" kv={self.kv_bytes_resident / 1e6:.2f}MB "
                      f"(-{self.kv_bytes_saved / 1e6:.2f}MB)")
        return (f"n={len(lat)} {pct}"
                f"slo={self.attainment * 100:.1f}% "
                f"thpt={self.throughput:.2f} req/s "
                f"rej={self.rejected} drop={self.dropped} "
                f"preempt={self.preemptions}{extra}")

    @classmethod
    def from_requests(cls, requests: Sequence, deadline: float,
                      *, iterations: int = 0) -> "ServeStats":
        # three outcomes: SERVED (finished with its tokens), REJECTED
        # (finished with an empty output despite wanting tokens), DROPPED
        # (stranded in the loop, finish_time still None). Latency
        # percentiles and throughput cover served requests only; both
        # other outcomes count against attainment.
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


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def run_serve_loop(workers: Sequence, requests: Sequence, *, deadline: float,
                   clock=None, dispatch=None) -> ServeStats:
    """Replay a timed workload over `workers` and account the outcome.

    Mutates each request in place (`start_time`, `finish_time`, `output`)
    and returns the ServeStats. Dispatch is iteration-level least-loaded
    with a DETERMINISTIC tiebreak (lowest replica id, falling back to
    worker order) so identical workloads route identically run-to-run;
    ``dispatch(cands, req, now) -> worker`` overrides the choice entirely
    (the Router's seeded tiebreaks).
    """
    clock = clock if clock is not None else WallClock()
    pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
    idx = 0
    iterations = 0
    # workers persist across serve() calls: report this replay's deltas
    wid = {id(w): getattr(w, "replica_id", i) for i, w in enumerate(workers)}
    base = {id(w): {c: getattr(w, c, 0) for c in COUNTERS} for w in workers}
    while idx < len(pending) or any(w.inflight() for w in workers):
        now = clock.now()
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
            idx += 1
            progressed = True

        # -- one iteration on every busy worker ---------------------------
        # Workers are parallel replicas: in virtual time a cycle costs the
        # SLOWEST busy worker's iteration, not the sum, so the clock ticks
        # once per cycle and completions are stamped after the tick.
        max_cost = 0.0
        completed = []
        for w in workers:
            if not w.busy(now):
                continue
            done, cost = w.run_iteration(now)
            iterations += 1
            progressed = True
            max_cost = max(max_cost, cost)
            completed.extend(done)
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
        # past instant would spin the loop forever)
        targets = []
        if idx < len(pending) and pending[idx].arrival > now:
            targets.append(pending[idx].arrival)
        for w in workers:
            t = w.next_event(now)
            if t is not None and t > now:
                targets.append(t)
        if not targets:
            # nothing runnable, nothing scheduled: whatever is still
            # pending or inflight is STRANDED and reported as dropped
            break
        clock.sleep_until(min(targets))

    stats = ServeStats.from_requests(pending, deadline,
                                     iterations=iterations)
    for c in COUNTERS:
        setattr(stats, c, sum(getattr(w, c, 0) - base[id(w)][c]
                              for w in workers))
    return stats
