"""Metrics registry: labeled counters, gauges, and explicit-bucket
histograms with deterministic JSONL export.

``MetricsRegistry`` is the typed store behind serving observability:
the serve loop publishes its counters and latency distributions here
(``ServeStats.publish``), engines publish per-phase durations, and the
calibration layer (``repro_torch.obs.calibration``) reads phase histograms
back out. Instruments are keyed by ``(kind, name, sorted(labels))`` so
the same name with different label sets (replica, stage, phase, ...)
stays distinct, Prometheus-style, without any global state.

Everything is plain Python floats/ints — no numpy in the hot path —
and ``collect()`` orders rows by key so exports are byte-deterministic
under ``VirtualClock`` runs.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# default latency buckets (seconds) — powers-of-two-ish decade sweep
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0)


def _labelkey(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, v=1) -> None:
        self.value += v


class Gauge:
    """Last-write-wins sample with a high-water mark."""

    __slots__ = ("value", "peak")

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0

    def set(self, v) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v


class Histogram:
    """Explicit-bucket histogram (upper-bound edges, +Inf implicit)
    that also tracks sum/count/min/max so means survive export."""

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                break
        else:
            self.counts[len(self.buckets)] += 1
        self.sum += v
        self.count += 1
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (upper-bound estimate; exact
        percentiles need the raw samples, which ServeStats keeps)."""
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i < len(self.buckets):
                    return self.buckets[i]
                return self.max if self.max is not None else 0.0
        return self.max if self.max is not None else 0.0


class MetricsRegistry:
    """Instrument factory + store. ``counter/gauge/histogram`` create on
    first use and return the live instrument thereafter."""

    def __init__(self):
        self._store: Dict[Tuple[str, str, LabelKey], object] = {}

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, _labelkey(labels))
        inst = self._store.get(key)
        if inst is None:
            inst = self._store[key] = factory()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, *, buckets: Sequence[float] =
                  DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets))

    # -- queries ----------------------------------------------------------
    def value(self, name: str, **labels) -> Optional[float]:
        """Counter value or gauge sample for an exact (name, labels) key;
        None if absent."""
        for kind in ("counter", "gauge"):
            inst = self._store.get((kind, name, _labelkey(labels)))
            if inst is not None:
                return inst.value
        return None

    def total(self, name: str) -> float:
        """Sum of a counter across ALL label sets."""
        return sum(inst.value for (kind, n, _), inst in self._store.items()
                   if kind == "counter" and n == name)

    def histograms(self, name: str) -> List[Tuple[dict, Histogram]]:
        """All (labels, histogram) pairs for a name, key-ordered."""
        out = []
        for key in sorted(self._store):
            kind, n, lk = key
            if kind == "histogram" and n == name:
                out.append((dict(lk), self._store[key]))
        return out

    # -- export -----------------------------------------------------------
    def collect(self) -> List[dict]:
        """One row per instrument, ordered by key (deterministic)."""
        rows = []
        for key in sorted(self._store):
            kind, name, lk = key
            inst = self._store[key]
            row = {"kind": kind, "name": name, "labels": dict(lk)}
            if kind == "counter":
                row["value"] = inst.value
            elif kind == "gauge":
                row["value"] = inst.value
                row["peak"] = inst.peak
            else:
                row.update(buckets=list(inst.buckets),
                           counts=list(inst.counts), sum=inst.sum,
                           count=inst.count, min=inst.min, max=inst.max)
            rows.append(row)
        return rows

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.collect():
                f.write(json.dumps(row, sort_keys=True,
                                   separators=(",", ":")) + "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "MetricsRegistry":
        reg = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                labels = row.get("labels", {})
                if row["kind"] == "counter":
                    reg.counter(row["name"], **labels).inc(row["value"])
                elif row["kind"] == "gauge":
                    g = reg.gauge(row["name"], **labels)
                    g.set(row.get("peak", row["value"]))
                    g.set(row["value"])
                else:
                    h = reg.histogram(row["name"],
                                      buckets=row["buckets"], **labels)
                    h.counts = list(row["counts"])
                    h.sum = row["sum"]
                    h.count = row["count"]
                    h.min = row["min"]
                    h.max = row["max"]
        return reg


def phase_histograms_from_trace(tracer, registry: MetricsRegistry,
                                *, phases: Iterable[str] = ()) -> None:
    """Bridge: fold a tracer's complete events into per-(replica, phase)
    ``phase_seconds`` histograms (and ``phase_units`` counters when a
    span carries a ``tokens`` arg), so the calibration layer and the
    report CLI consume the metrics stream rather than raw spans."""
    want = set(phases) if phases else None
    for ev in tracer.events:
        if ev.get("ph") != "X":
            continue
        name = ev["name"]
        if want is not None and name not in want:
            continue
        labels = {"replica": str(ev.get("pid", 0)), "phase": name}
        registry.histogram("phase_seconds", **labels).observe(ev["dur"])
        toks = (ev.get("args") or {}).get("tokens")
        if toks:
            registry.counter("phase_units", **labels).inc(toks)
