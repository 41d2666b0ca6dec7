"""The port's four examples (examples/torch_*.py, the counterparts of
quickstart.py, schedule_explore.py, serve_heterogeneous.py and
train_quickstart.py) run on the CPU with minimal arguments and drive
repro_torch, never repro."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = {
    "torch_quickstart.py": (["--device", "cpu"], "OK on cpu"),
    "torch_schedule_explore.py": (["--iters", "2"],
                                  "== hetero half-price 30 GPUs"),
    "torch_serve_heterogeneous.py": (["--device", "cpu", "--duration", "1",
                                      "--search-iters", "2"], "slo="),
    "torch_train_quickstart.py": (["--steps", "2", "--device", "cpu",
                                   "--reduced", "--log-every", "1"],
                                  "step     2 loss"),
}


def test_examples_run_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name), *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, (argv, _) in RUNS.items()}
    for name, p in procs.items():
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, (name, err[-2000:])
        assert RUNS[name][1] in out, (name, out[-2000:])
    for name in RUNS:
        with open(os.path.join(ROOT, "examples", name)) as f:
            src = f.read()
        assert "repro_torch" in src
        assert "from repro." not in src and "import repro\n" not in src
        assert "repro.launch" not in src.replace("repro_torch.launch", "")
