"""Observability report CLI: summarize a metrics JSONL export, validate a
Chrome-trace JSON, and print the calibration table.

  python -m repro_torch.obs.report metrics.jsonl
  python -m repro_torch.obs.report metrics.jsonl --trace trace.json \\
      --require-spans prefill,decode
  python -m repro_torch.obs.report --trace trace.json

Exit status is nonzero when a given trace fails schema validation or
misses a required span — ``scripts/ci.sh`` uses exactly that as the
trace smoke's gate.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.obs.calibration import CostCalibrator
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import validate_chrome_trace


def summarize_metrics(reg: MetricsRegistry) -> List[str]:
    lines: List[str] = []
    counters = [r for r in reg.collect() if r["kind"] == "counter"
                and r["value"]]
    gauges = [r for r in reg.collect() if r["kind"] == "gauge"]
    hists = [r for r in reg.collect() if r["kind"] == "histogram"
             and r["count"]]

    def lbl(row):
        return ",".join(f"{k}={v}" for k, v in sorted(row["labels"].items()))
    if counters:
        lines.append("counters:")
        lines.extend(f"  {r['name']}{{{lbl(r)}}} = {r['value']}"
                     for r in counters)
    if gauges:
        lines.append("gauges:")
        lines.extend(f"  {r['name']}{{{lbl(r)}}} = {r['value']:g} "
                     f"(peak {r['peak']:g})" for r in gauges)
    if hists:
        lines.append("histograms:")
        for r in hists:
            mean = r["sum"] / r["count"]
            lines.append(f"  {r['name']}{{{lbl(r)}}} n={r['count']} "
                         f"mean={mean:.4g} min={r['min']:.4g} "
                         f"max={r['max']:.4g}")
    return lines


def summarize_trace(obj: dict) -> List[str]:
    by_name: dict = {}
    for ev in obj.get("traceEvents", []):
        name = ev.get("name", "?")
        n, dur = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, dur + ev.get("dur", 0))
    lines = [f"trace: {sum(n for n, _ in by_name.values())} events"]
    for name in sorted(by_name):
        n, dur = by_name[name]
        lines.append(f"  {name}: {n} spans, {dur / 1e6:.3f}s total")
    return lines


def calibration_table(cal: CostCalibrator) -> List[str]:
    rows = cal.report()
    if not rows:
        return []
    lines = ["calibration (predicted vs observed seconds/unit):",
             f"  {'replica':>7} {'phase':<14} {'predicted':>10} "
             f"{'observed':>10} {'rel_err':>8} {'spans':>6}"]
    for r in rows:
        pred = f"{r['predicted']:.4g}" if r["predicted"] is not None \
            else "-"
        rel = f"{r['rel_err'] * 100:.1f}%" if r["rel_err"] is not None \
            else "-"
        lines.append(f"  {r['replica']:>7} {r['phase']:<14} {pred:>10} "
                     f"{r['observed']:>10.4g} {rel:>8} {r['spans']:>6}")
    lines.append("  " + cal.summary())
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="summarize serving metrics / validate traces")
    ap.add_argument("metrics", nargs="?", default=None,
                    help="metrics JSONL from a serve (--metrics-out)")
    ap.add_argument("--trace", default=None,
                    help="Chrome-trace JSON to validate + summarize")
    ap.add_argument("--require-spans", default="",
                    help="comma-separated span names the trace must "
                         "contain (validation fails otherwise)")
    args = ap.parse_args(argv)
    if args.metrics is None and args.trace is None:
        ap.error("give a metrics JSONL and/or --trace")
    status = 0
    cal = CostCalibrator()
    if args.trace is not None:
        with open(args.trace) as f:
            obj = json.load(f)
        want = [s for s in args.require_spans.split(",") if s]
        errs = validate_chrome_trace(obj, require_spans=want)
        if errs:
            status = 1
            print(f"TRACE INVALID ({args.trace}):")
            for e in errs[:20]:
                print(f"  {e}")
        else:
            print(f"trace OK ({args.trace})")
        for line in summarize_trace(obj):
            print(line)
    if args.metrics is not None:
        reg = MetricsRegistry.from_jsonl(args.metrics)
        for line in summarize_metrics(reg):
            print(line)
        cal.observe_metrics(reg)
        for line in calibration_table(cal):
            print(line)
    return status


if __name__ == "__main__":
    sys.exit(main())
