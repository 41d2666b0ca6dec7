"""HexTrace: span-based request tracing over the serving clock.

The serving stack is instrumented with a single ``Tracer`` that rides
whatever clock the serve loop runs on (``WallClock`` or ``VirtualClock``)
and records three event shapes:

  * **complete events** — a named interval with an explicit duration.
    This is the workhorse: under ``VirtualClock`` the clock does NOT
    advance while a worker iteration runs (the loop ticks once per cycle
    by the slowest worker's cost), so engines report the virtual cost
    they attribute to each phase as the span duration instead of
    sampling the clock twice.
  * **begin/end spans** — a matched pair sampled from the clock, for
    intervals that straddle loop cycles (per-worker iteration spans).
    Every ``begin`` must be closed by ``end`` on the same code path —
    the repro-lint ``span-pairing`` rule enforces this statically.
  * **instant events** — zero-duration markers (preemption, replica
    kill, KVSAN audit).

Determinism contract: with tracing ON, serving must stay token-identical
to an untraced run (the tracer only reads state), and two seeded
``VirtualClock`` runs must produce byte-identical exports. Nothing in
this module consults wall time, object ids, or unordered iteration —
events serialize in append order with sorted keys.

Zero-overhead contract: ``NULL_TRACER`` is a singleton with
``enabled = False``; hot paths guard emission with
``if tracer.enabled:`` so tracing off costs one attribute load.

Export is the Chrome trace-event JSON format (the ``traceEvents`` array
of ``ph: "X"/"i"`` dicts) readable by Perfetto (https://ui.perfetto.dev)
and ``chrome://tracing``; ``pid`` is the replica id and ``tid`` the
stage/lane within it, so the timeline groups by replica.
"""
from __future__ import annotations

import contextlib
import json
from typing import Dict, List, Optional, Sequence

# one trace-time unit (clock seconds) = 1e6 Chrome microseconds
_US = 1_000_000

# span taxonomy (docs/observability.md mirrors this table)
SPAN_NAMES = (
    "queue_wait",        # admit: arrival -> start_time
    "iteration",         # per-worker engine iteration (begin/end pair)
    "prefill",           # prompt tokens computed this iteration (chunk)
    "decode",            # one decode step over the running batch
    "spec_propose",      # draft tokens proposed
    "spec_verify",       # multi-token verification step
    "spec_rollback",     # rejected-draft KV truncation
    "preempt",           # slot evicted (instant) + recompute accounted
    "host_spill",        # device -> host page demotion
    "host_promote",      # host -> device page swap-in
    "prefix_fetch",      # cluster prefix-directory block migration
    "kv_migration",      # disaggregated prefill -> decode KV handoff
    "live_move",         # online-resched live slot extraction
    "replica_kill",      # rescheduler killed a replica (instant)
)


class Span:
    """An open begin/end interval; closed by ``Tracer.end``."""

    __slots__ = ("name", "ts", "pid", "tid", "args")

    def __init__(self, name: str, ts: float, pid: int, tid: int,
                 args: Optional[dict]):
        self.name = name
        self.ts = ts
        self.pid = pid
        self.tid = tid
        self.args = args


class Tracer:
    """Collects trace events against a serving clock.

    Construct once per serve, ``bind_clock`` when the loop picks its
    clock (the Router does this), and hand the same instance to every
    engine. ``enabled`` is True; the NULL_TRACER stand-in is the off
    switch, so instrumentation sites never branch on a None check.
    """

    enabled = True

    def __init__(self, clock=None):
        self._clock = clock
        self.events: List[dict] = []
        # rid -> {"first_token": ts, "prefill_finish": ts}; the loop
        # re-derives Request timestamps from these marks after a traced
        # serve (the trace is the source of truth when tracing is on)
        self.request_marks: Dict[int, Dict[str, float]] = {}
        self._open = 0                 # begun-but-unended spans

    # -- clock ------------------------------------------------------------
    def bind_clock(self, clock) -> None:
        self._clock = clock

    def now(self) -> float:
        return self._clock.now() if self._clock is not None else 0.0

    # -- emission ---------------------------------------------------------
    def complete(self, name: str, dur: float, *, ts: Optional[float] = None,
                 pid: int = 0, tid: int = 0, **args) -> None:
        """Record a finished interval with an explicit duration."""
        ev = {"name": name, "ph": "X",
              "ts": self.now() if ts is None else ts,
              "dur": dur, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, *, ts: Optional[float] = None,
                pid: int = 0, tid: int = 0, **args) -> None:
        ev = {"name": name, "ph": "i",
              "ts": self.now() if ts is None else ts,
              "pid": pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def begin(self, name: str, *, pid: int = 0, tid: int = 0,
              **args) -> Span:
        """Open a clock-sampled span; MUST be closed with ``end`` on the
        same code path (repro-lint: span-pairing)."""
        self._open += 1
        return Span(name, self.now(), pid, tid, args or None)

    def end(self, span: Span, **args) -> None:
        self._open -= 1
        merged = dict(span.args) if span.args else {}
        merged.update(args)
        ev = {"name": span.name, "ph": "X", "ts": span.ts,
              "dur": self.now() - span.ts, "pid": span.pid,
              "tid": span.tid}
        if merged:
            ev["args"] = merged
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, pid: int = 0, tid: int = 0, **args):
        s = self.begin(name, pid=pid, tid=tid, **args)
        try:
            yield s
        finally:
            self.end(s)

    # -- request timestamp marks (satellite: timestamp sprawl) ------------
    def mark(self, rid: int, key: str, ts: float) -> None:
        """Stamp a request-lifecycle mark (first occurrence wins, matching
        the engines' ``if t is None`` stamping discipline)."""
        m = self.request_marks.setdefault(rid, {})
        if key not in m:
            m[key] = ts

    def apply_marks(self, requests: Sequence) -> None:
        """Re-derive Request timestamps from the trace. With tracing on
        the span stream is the source of truth for ``first_token_time``
        and ``prefill_finish_time``; values must agree with what the
        engines stamped inline (tests assert equality)."""
        for r in requests:
            m = self.request_marks.get(r.rid)
            if not m:
                continue
            if "first_token" in m:
                r.first_token_time = m["first_token"]
            if "prefill_finish" in m:
                r.prefill_finish_time = m["prefill_finish"]

    # -- export -----------------------------------------------------------
    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (ts/dur in microseconds)."""
        out = []
        for ev in self.events:
            d = dict(ev)
            d["ts"] = round(d["ts"] * _US)
            if "dur" in d:
                d["dur"] = round(d["dur"] * _US)
            out.append(d)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.trace",
                              "openSpans": self._open}}

    def dumps(self) -> str:
        """Byte-deterministic serialization (sorted keys, fixed
        separators, append-ordered events)."""
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":"))

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())
            f.write("\n")


class _NullTracer(Tracer):
    """Tracing off: every emission is a no-op; ``enabled`` is False so
    hot paths can skip argument construction entirely."""

    enabled = False

    def __init__(self):
        super().__init__()

    def complete(self, name, dur, *, ts=None, pid=0, tid=0, **args):
        pass

    def instant(self, name, *, ts=None, pid=0, tid=0, **args):
        pass

    def begin(self, name, *, pid=0, tid=0, **args):
        return _NULL_SPAN

    def end(self, span, **args):
        pass

    def mark(self, rid, key, ts):
        pass

    def apply_marks(self, requests):
        pass


_NULL_SPAN = Span("", 0.0, 0, 0, None)
NULL_TRACER = _NullTracer()


# ---------------------------------------------------------------------------
# Chrome-trace schema validation (ci.sh trace smoke, tests)
# ---------------------------------------------------------------------------

def validate_chrome_trace(obj, *, require_spans: Sequence[str] = ()
                          ) -> List[str]:
    """Structural check of a Chrome trace-event JSON object. Returns a
    list of problems (empty = valid). ``require_spans`` additionally
    demands at least one event with each given name."""
    errs: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' array"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be an array"]
    names = set()
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                errs.append(f"{where}: missing '{k}'")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            errs.append(f"{where}: unknown phase {ph!r}")
        if ph == "X" and "dur" not in ev:
            errs.append(f"{where}: complete event missing 'dur'")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: bad ts {ts!r}")
        if "dur" in ev and (not isinstance(ev["dur"], (int, float))
                            or ev["dur"] < 0):
            errs.append(f"{where}: bad dur {ev['dur']!r}")
        if isinstance(ev.get("name"), str):
            names.add(ev["name"])
    open_spans = (obj.get("otherData") or {}).get("openSpans", 0)
    if open_spans:
        errs.append(f"{open_spans} span(s) begun but never ended")
    for want in require_spans:
        if want not in names:
            errs.append(f"no '{want}' span in trace")
    return errs
