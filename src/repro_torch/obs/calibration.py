"""Predicted-vs-observed cost calibration.

HexGen's scheduler stakes every placement on ``core.cost_model`` phase
costs, and ROADMAP's "validate the cost model against reality" needs a
measurement to validate AGAINST. ``CostCalibrator`` holds both sides:

  * **predictions** — per-(replica, phase) expected seconds per unit,
    registered by whoever planned the serve (``launch.serve`` derives
    them from ``cost_model.pipeline_phase_costs`` /
    ``predicted_phase_seconds``; benches may use
    ``slo_sim.PhasedReplicaModel`` figures directly).
  * **observations** — span durations from the trace (or the
    ``phase_seconds`` histograms the metrics bridge builds), normalized
    to the same unit.

Units per phase: ``prefill`` and ``spec_propose`` are per TOKEN (spans
carry a ``tokens`` arg), everything else is per SPAN (one decode
iteration, one block swap, one fetch, one handoff).

``report()`` yields one row per (replica, phase) with absolute and
relative error, and ``feed()`` pushes the errors into a drift detector
(duck-typed: anything with ``observe_model_error``, as
``repro_torch.core.resched.DriftDetector``) as the model-error drift
signal.

Port of repro.obs.calibration, line for line.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# phases whose span durations amortize over a token count
PER_TOKEN_PHASES = ("prefill", "spec_propose")

# lifecycle phases the calibrator aggregates from a trace (per-worker
# "iteration" and admission "queue_wait" spans stay out: they overlap the
# inner phases and would double-count)
PHASES = ("prefill", "decode", "spec_propose", "spec_verify",
          "host_spill", "host_promote", "prefix_fetch", "kv_migration")


class CostCalibrator:
    """Accumulates per-(replica, phase) predictions and observations."""

    def __init__(self):
        self._pred: Dict[Tuple[int, str], float] = {}
        # (replica, phase) -> [seconds, units, spans]
        self._obs: Dict[Tuple[int, str], List[float]] = {}

    # -- predictions ------------------------------------------------------
    def predict(self, replica: int, phase: str, seconds: float) -> None:
        """Register the model's expected seconds per unit of `phase` on
        `replica` (token for per-token phases, span otherwise)."""
        self._pred[(int(replica), phase)] = float(seconds)

    # -- observations -----------------------------------------------------
    def observe(self, replica: int, phase: str, seconds: float,
                units: float = 1.0) -> None:
        acc = self._obs.setdefault((int(replica), phase), [0.0, 0.0, 0])
        acc[0] += float(seconds)
        acc[1] += float(units)
        acc[2] += 1

    def observe_trace(self, tracer) -> None:
        """Fold a tracer's complete events into observations."""
        for ev in tracer.events:
            if ev.get("ph") != "X" or ev["name"] not in PHASES:
                continue
            args = ev.get("args") or {}
            units = (args.get("tokens", 1)
                     if ev["name"] in PER_TOKEN_PHASES else 1)
            self.observe(ev.get("pid", 0), ev["name"], ev["dur"],
                         max(units, 1))

    def observe_metrics(self, registry) -> None:
        """Read observations back out of ``phase_seconds`` histograms /
        ``phase_units`` counters (the metrics-stream path: a report can
        calibrate from an exported metrics.jsonl alone)."""
        for labels, h in registry.histograms("phase_seconds"):
            phase = labels.get("phase", "")
            if phase not in PHASES or not h.count:
                continue
            rep = int(labels.get("replica", 0))
            units = h.count
            if phase in PER_TOKEN_PHASES:
                toks = registry.value("phase_units", **labels)
                if toks:
                    units = toks
            acc = self._obs.setdefault((rep, phase), [0.0, 0.0, 0])
            acc[0] += h.sum
            acc[1] += units
            acc[2] += h.count

    # -- the report -------------------------------------------------------
    def report(self) -> List[dict]:
        """One row per (replica, phase) that has observations, key-ordered:
        predicted and observed seconds per unit, span/unit counts, and
        absolute + relative error (None when no prediction exists)."""
        rows = []
        for (rep, phase) in sorted(self._obs):
            sec, units, spans = self._obs[(rep, phase)]
            observed = sec / units if units else 0.0
            pred = self._pred.get((rep, phase))
            row = {"replica": rep, "phase": phase,
                   "predicted": pred, "observed": observed,
                   "spans": spans, "units": units,
                   "abs_err": None, "rel_err": None}
            if pred is not None:
                row["abs_err"] = abs(observed - pred)
                row["rel_err"] = (abs(observed - pred) / pred
                                  if pred > 0 else None)
            rows.append(row)
        return rows

    def feed(self, detector) -> int:
        """Push every row with a prediction into a DriftDetector's
        model-error window; returns the rows fed."""
        n = 0
        for row in self.report():
            if row["predicted"] is None:
                continue
            detector.observe_model_error(row["phase"], row["predicted"],
                                         row["observed"])
            n += 1
        return n

    def summary(self) -> str:
        rows = [r for r in self.report() if r["rel_err"] is not None]
        if not rows:
            return "calibration: no predicted phases observed"
        worst = max(rows, key=lambda r: r["rel_err"])
        mean = sum(r["rel_err"] for r in rows) / len(rows)
        return (f"calibration: {len(rows)} (replica, phase) pairs, "
                f"mean rel err {mean * 100:.1f}%, worst "
                f"{worst['phase']}@r{worst['replica']} "
                f"{worst['rel_err'] * 100:.1f}%")


def predictions_from_phase_costs(cal: CostCalibrator, replica: int,
                                 pc, s_in: int) -> None:
    """Register a replica's predictions from a ``cost_model.PhaseCosts``:
    prefill normalizes to seconds/token over the planned prompt length,
    decode is seconds per iteration."""
    cal.predict(replica, "prefill", pc.prefill_latency / max(s_in, 1))
    cal.predict(replica, "decode", pc.decode_latency)
