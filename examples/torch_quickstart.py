"""Quickstart of the PyTorch port: schedule a heterogeneous pool with
HexGen's two-phase search, then generate tokens through the port's
asymmetric pipeline engine (the counterpart of quickstart.py).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless given ``--device cpu`` (the plain PyTorch
versions of the kernels); the weights are seeded.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import cluster as cl
from repro_torch.core import cost_model as cm
from repro_torch.core.scheduler import schedule
from repro_torch.launch.serve import scale_assignment
from repro_torch.serving.engine import InferenceEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# 1. the paper's case-study pool: 4xA6000 + 2xA5000 + 2xA4000
pool = cl.case_study_cluster()
print(f"pool: {len(pool)} GPUs, ${pool.price_per_hour:.2f}/h")

# 2. schedule LLAMA-2 (70B) service over it (cost model + DP + genetic)
task = cm.Task(batch=1, s_in=128, s_out=64)
res = schedule(pool, "llama2-70b", task, deadline=20.0, rate=0.5,
               iters=8, seed=0, paper_exact=True)
print(f"assignment: {res.assignment.describe()}")
print(f"estimated SLO attainment: {res.attainment*100:.0f}%")

# 3. execute the scheduled layout with a reduced model: the same stage
#    structure and TP degrees over the visible devices (on one card every
#    stage runs whole), fewer / smaller layers
cfg_full = get_config("llama2-70b")
cfg = cfg_full.reduced()
asg = scale_assignment(res.assignment, cfg_full.num_layers, cfg.num_layers)
engine = InferenceEngine(cfg, asg, device=args.device)

prompts = [np.arange(5, 13, dtype=np.int32),
           np.arange(40, 52, dtype=np.int32)]
outs = engine.generate(prompts, max_new=8)
for p, o in zip(prompts, outs):
    print(f"prompt[{len(p)} toks] -> {o.tolist()}")
print(f"OK on {engine.device}")
