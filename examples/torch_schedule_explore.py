"""Explore the port's scheduler: search convergence on the full-price
pool, the layouts it discovers, and what-if pricing (half budget, TPU
slices); the counterpart of schedule_explore.py.

  PYTHONPATH=src python examples/torch_schedule_explore.py [--iters 15]

The search runs on the host: it prices the pools' GPUs with the cost
model and touches no device.
"""
import argparse

from repro_torch.core import cluster as cl
from repro_torch.core import cost_model as cm
from repro_torch.core.scheduler import schedule

ap = argparse.ArgumentParser()
ap.add_argument("--iters", type=int, default=15)
args = ap.parse_args()

task = cm.Task(batch=1, s_in=128, s_out=32)

for name, pool, rate in (
        ("homogeneous 16xA100 ($65.54/h)", cl.homogeneous_a100(), 6.0),
        ("hetero full-price 58 GPUs ($65/h)", cl.hetero_full_price(), 6.0),
        ("hetero half-price 30 GPUs ($30/h)", cl.hetero_half_price(), 6.0),
        ("mixed TPU v5e slices (beyond-paper)", cl.tpu_mixed_slices(), 2.0)):
    res = schedule(pool, "llama2-70b", task, deadline=10.0, rate=rate,
                   iters=args.iters, seed=0, paper_exact=True)
    print(f"\n== {name} ==")
    print(f"  replicas: {res.assignment.num_replicas}  "
          f"attainment@{rate}req/s: {res.attainment*100:.0f}%  "
          f"search evals: {res.evaluations}")
    for p in res.assignment.pipelines:
        print(f"    {p.describe()}  latency={p.cost:.2f}s "
              f"bottleneck={p.bottleneck:.2f}s")
