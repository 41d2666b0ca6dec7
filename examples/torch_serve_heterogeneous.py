"""End-to-end serving driver of the port: schedule the paper's half-price
heterogeneous pool, stand up the port's multi-replica asymmetric-pipeline
engine, and serve a timed Poisson workload, reporting measured SLO
attainment (the counterpart of serve_heterogeneous.py).

  PYTHONPATH=src python examples/torch_serve_heterogeneous.py \\
      [--device cpu] [launcher flags, e.g. --duration 2]

Runs on the card unless given ``--device cpu``. Further flags go to
``repro_torch.launch.serve`` after the example's own, so they override
them.
"""
import argparse

from repro_torch.launch import serve

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args, rest = ap.parse_known_args()

# the serving driver is the launcher's main; this example drives it the
# way an operator would, on the device asked for
serve.main([
    "--arch", "h2o-danube-1.8b", "--reduced",
    "--cluster", "half_price",
    "--rate", "3", "--duration", "4", "--deadline", "30",
    "--prompt-len", "16", "--out-len", "6", "--search-iters", "6",
    *rest], device=args.device)
