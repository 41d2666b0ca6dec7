"""Serving driver of the port: schedule a heterogeneous pool, build the
asymmetric pipeline engine, and serve a Poisson workload end to end on the
card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-70b \
      --reduced --cluster case_study --cache-layout paged --rate 4 \
      --duration 1 --out-len 4 --search-iters 2

Every flag is a ``serving.config.ServingConfig`` field, as in the
reference's ``repro.launch.serve``; this driver is the parse -> schedule
-> build -> serve spine. The scheduler plans for the FULL model on the
chosen GPU pool (the paper's setting); ``--reduced`` serves the reduced
variant of the same architecture through the scheduled stage layout,
keeping every structural property (stage count, TP degrees, layer ratios).
The plan's device ids map onto every visible device of ``main(device=
...)``'s type (the cards unless a test asks for the CPU), as in the
reference engine: one card runs every stage whole; several run a TP > 1
stage as shards on distinct cards. The launcher prints each replica's
stages' physical devices (``DEVICES_LINE``). ``--trace-out`` writes the serve's
Chrome trace, ``--metrics-out`` its metrics JSONL (read them back with
``python -m repro_torch.obs.report``), and ``--calibrate`` prints the cost
model's predicted seconds per phase against the traced ones. The traced
engine spans last the cost the engines charge on the serving clock (see
``repro_torch.obs``), so the table's "observed" column is a modelled cost
on the wall clock too; the launcher says so under the table.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.plan import Assignment, PipelinePlan, StagePlan
from repro_torch.core.scheduler import schedule
from repro_torch.serving.config import ServingConfig

# printed under the calibration table: what its "observed" column is
CALIBRATION_NOTE = ("  (observed: the engine spans' charged serving-clock "
                    "cost, on any clock; not a measured device time)")
# the start of the line naming a replica's stages' devices (port only)
DEVICES_LINE = "  devices of replica "


def scale_assignment(asg: Assignment, full_layers: int,
                     run_layers: int) -> Assignment:
    """Project a full-model layer split onto the reduced layer count,
    keeping stage proportions (>=1 layer per stage; stages collapse if the
    reduced model has fewer layers than stages)."""
    out = []
    for pipe in asg.pipelines:
        stages = pipe.stages[:run_layers]
        raw = [s.num_layers / full_layers * run_layers for s in stages]
        ls = [max(1, int(round(r))) for r in raw]
        while sum(ls) > run_layers:
            i = max(range(len(ls)), key=lambda i: ls[i] - raw[i])
            if ls[i] > 1:
                ls[i] -= 1
            else:
                ls.pop(i)
                stages = stages[:i] + stages[i + 1:]
                raw.pop(i)
        while sum(ls) < run_layers:
            i = min(range(len(ls)), key=lambda i: ls[i] - raw[i])
            ls[i] += 1
        out.append(PipelinePlan(
            [StagePlan(list(s.device_ids), l) for s, l in zip(stages, ls)],
            cost=pipe.cost, bottleneck=pipe.bottleneck))
    return Assignment(out)


def main(argv: Optional[Sequence[str]] = None, *, device="cuda") -> None:
    sv = ServingConfig.parse(argv).normalized()
    pool = sv.pool()
    cfg_full = get_config(sv.arch)
    print(f"scheduling {sv.arch} on {sv.cluster} "
          f"({len(pool)} GPUs, ${pool.price_per_hour:.2f}/h)...")
    res = schedule(pool, sv.arch, sv.task(), **sv.schedule_kwargs())
    plan = res.plan
    print(f"  assignment: {plan.assignment.describe()}")
    print(f"  estimated SLO attainment: {res.attainment*100:.1f}%")
    if sv.disaggregate:
        print(f"  roles: "
              f"{plan.roles if plan.roles is not None else 'colocated'}")
    if sv.spec_decode:
        print(f"  spec-k per replica: {plan.spec_ks}")
    if sv.kv_dtype == "search":
        shown = [d or "auto" for d in (plan.kv_dtypes or [])]
        print(f"  kv-dtype per replica: {shown}")
    if sv.host_mem_gb > 0:
        print(f"  host-tier blocks per replica: {plan.host_blocks}")

    from repro_torch.serving.engine import InferenceEngine
    cfg = cfg_full.reduced() if sv.reduced else cfg_full
    asg = scale_assignment(plan.assignment, cfg_full.num_layers,
                           cfg.num_layers) if sv.reduced else None
    engine = InferenceEngine.from_config(cfg, plan, sv, assignment=asg,
                                         cluster=pool, device=device)
    for i, rep in enumerate(engine.replicas):
        print(f"{DEVICES_LINE}{i}: " + "; ".join(
            f"stage {si} " + ", ".join(devs)
            for si, devs in enumerate(rep.describe_devices())))
    reqs = sv.workload(cfg.vocab_size)

    # ---- observability (repro_torch.obs) --------------------------------
    tracer = metrics = None
    if sv.trace_out or sv.calibrate:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    if sv.metrics_out or sv.calibrate:
        from repro_torch.obs.metrics import MetricsRegistry
        metrics = MetricsRegistry()

    print(f"serving {len(reqs)} requests...")
    stats = engine.serve(reqs, deadline=sv.deadline, tracer=tracer,
                         metrics=metrics)
    print("  " + stats.summary())

    if tracer is not None and metrics is not None:
        from repro_torch.obs.metrics import phase_histograms_from_trace
        phase_histograms_from_trace(tracer, metrics)
    if sv.trace_out:
        tracer.write(sv.trace_out)
        print(f"  trace: {sv.trace_out} ({len(tracer.events)} events)")
    if sv.metrics_out:
        metrics.to_jsonl(sv.metrics_out)
        print(f"  metrics: {sv.metrics_out}")
    if sv.calibrate:
        from repro_torch.core import cost_model as cm
        from repro_torch.obs.calibration import (CostCalibrator,
                                                 predictions_from_phase_costs)
        from repro_torch.obs.report import calibration_table
        cal = CostCalibrator()
        task = sv.task()
        profile = cm.ModelProfile.from_config(
            cfg_full, bytes_per_el=task.bytes_per_el)
        for i, pipe in enumerate(plan.assignment.pipelines):
            pc = cm.pipeline_phase_costs(
                pool, [list(s.device_ids) for s in pipe.stages],
                [s.num_layers for s in pipe.stages], profile, task)
            predictions_from_phase_costs(cal, i, pc, task.s_in)
        cal.observe_trace(tracer)
        for line in calibration_table(cal):
            print("  " + line)
        print(CALIBRATION_NOTE)


if __name__ == "__main__":
    main()
