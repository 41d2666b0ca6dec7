"""Train a ~100M-param model for a few hundred steps on the synthetic
Markov stream with the port, with checkpointing (xlstm-125m's full
config; the counterpart of train_quickstart.py).

  PYTHONPATH=src python examples/torch_train_quickstart.py [--steps 300] \\
      [--device cpu] [launcher flags, e.g. --reduced]

Runs on the card unless given ``--device cpu``. ``--steps`` and any
further flags go to ``python -m repro_torch.launch.train``; checkpoints
go to a fresh temporary directory.
"""
import os
import subprocess
import sys
import tempfile

args = sys.argv[1:]
steps = "300" if "--steps" not in args else args[args.index("--steps") + 1]
rest = [a for i, a in enumerate(args) if a != "--steps"
        and (i == 0 or args[i - 1] != "--steps")]
with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt_dir:
    subprocess.run([
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "xlstm-125m",
        "--steps", steps, "--batch", "4", "--seq", "128",
        "--lr", "1e-3", "--ckpt-dir", ckpt_dir,
        "--ckpt-every", "100", "--log-every", "20", *rest,
    ], check=True, env={"PYTHONPATH": "src", **os.environ})
