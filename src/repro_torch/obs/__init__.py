"""Observability of the port (copy of repro.obs): span tracing, metrics,
and cost calibration.

Three layers, each consumable alone:

  * ``repro_torch.obs.trace``        — ``Tracer`` riding the serving clock;
    Chrome-trace/Perfetto JSON export; ``NULL_TRACER`` zero-overhead off
    switch.
  * ``repro_torch.obs.metrics``      — ``MetricsRegistry`` of labeled
    counters/gauges/histograms with deterministic JSONL export;
    ``ServeStats`` publishes into it as a back-compat view.
  * ``repro_torch.obs.calibration``  — predicted (cost_model/slo_sim) vs
    observed (span durations) per-(replica, phase) error report.

``python -m repro_torch.obs.report`` summarizes/validates the exports.

Only the ``serve`` and ``queue_wait`` spans are sampled from the serving
clock. Every engine span (``iteration``, ``prefill``, ``decode``,
``spec_propose``, ``spec_verify``, ``host_spill``, ``host_promote``,
``prefix_fetch``, ``kv_migration``) lasts the cost the engines charge on
the serving clock, as in the reference, on a ``WallClock`` too: those
spans, the phase histograms built from them and the calibrator's
"observed" column are modelled costs, never measured times.
"""
from repro_torch.obs.calibration import (CostCalibrator,
                                         predictions_from_phase_costs)
from repro_torch.obs.metrics import (MetricsRegistry,
                                     phase_histograms_from_trace)
from repro_torch.obs.trace import (NULL_TRACER, Span, Tracer,
                                   validate_chrome_trace)

__all__ = [
    "CostCalibrator", "MetricsRegistry", "NULL_TRACER", "Span", "Tracer",
    "phase_histograms_from_trace", "predictions_from_phase_costs",
    "validate_chrome_trace",
]
