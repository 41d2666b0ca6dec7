"""Dry run: count every (arch x input shape) step on the meta device, or
run it on the card, and report its memory and roofline terms on one
NVIDIA H100 (the port of repro.launch.dryrun, which lowers and compiles
on a TPU mesh).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-70b \\
      --shape prefill_32k --device cuda --layers 2 --batch 1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-70b \\
      --shape decode_32k --mesh 16x16 [--multi-pod]

The default device is ``meta``, as the reference's dry run allocates
nothing: the step runs on shapes and dtypes, counted by
``op_analysis.OpCounter``; ``--all`` sweeps every architecture and shape
in one process. ``--device cuda`` runs the same step on the card through
the kernels (``--layers`` / ``--batch`` cut it to one card, listed in the
record's ``reduced``) and adds the step's time (CUDA events, median of 3
after a warm-up), the peak of allocated memory and the roofline share,
beside the card's name and power limit. Without a card it raises; there is
no CPU fallback.

``--mesh DATAxMODEL`` counts card 0's share of the step on a (data, model)
mesh of that many H100s (``launch.specs``: the batch over the data axis,
the layers as shard 0 of tensor parallelism over the model axis), as the
reference's dry run compiles one chip's partition: per-card FLOPs, bytes
and collective bytes (each reduction the shard shares, by kind), the
collective term on NVLink (``launch.roofline``) and ``chips``.
``--multi-pod`` prefixes a pod axis of 2 (the reference's (2, 16, 16));
``--mesh`` alone with ``--multi-pod`` takes the production (2, 16, 16).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import list_archs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_analysis, roofline, specs
from repro_torch.models import shardings

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _storages(tree):
    """{id: nbytes} of the distinct storages of tree's tensors."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def count_step(fn, args):
    """Run fn(*args) inside an OpCounter that excludes the arguments'
    storages. Returns (counter, memory_analysis, fn's result): argument,
    output (results that are not arguments), alias (results that are) and
    temp (the peak of the storages the step allocated) bytes."""
    counter = op_analysis.OpCounter()
    counter.exclude(args)
    arg_st = _storages(args)
    # the cyclic collector stays off while counting: when it runs decides
    # whether autograd takes a gradient or copies it (by the tensor's
    # reference count), so two passes of one step could count differently
    gc.disable()
    try:
        with counter:
            out = fn(*args)
    finally:
        gc.enable()
    out_st = _storages(out)
    mem = {"argument_size_in_bytes": sum(arg_st.values()),
           "output_size_in_bytes": sum(n for k, n in out_st.items()
                                       if k not in arg_st),
           "alias_size_in_bytes": sum(n for k, n in out_st.items()
                                      if k in arg_st),
           "temp_size_in_bytes": counter.peak_live_bytes}
    return counter, mem, out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def time_step(fn, args, reps: int = 3):
    """(median ms of `reps` calls after one warm-up, by CUDA events; peak
    allocated bytes over them)."""
    fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), torch.cuda.max_memory_allocated()


def parse_mesh(text: str, multi_pod: bool = False):
    """"DATAxMODEL" (e.g. "16x16") -> a (data, model) mesh, with a pod
    axis of 2 in front under `multi_pod`."""
    try:
        data, model = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: give DATAxMODEL, e.g. 16x16")
    if multi_pod:
        return mesh_lib.make_mesh((2, data, model),
                                  ("pod", "data", mesh_lib.MODEL_AXIS))
    return mesh_lib.make_mesh((data, model), ("data", mesh_lib.MODEL_AXIS))


def run_one(arch: str, shape_name: str, *, device="meta", layers=None,
            batch=None, verbose: bool = True, mesh=None,
            multi_pod: bool = False) -> dict:
    fn, args, cfg, shape, reduced = specs.build_dryrun(
        arch, shape_name, device=device, layers=layers, batch=batch,
        mesh=mesh, multi_pod=multi_pod)
    counter, mem, out = count_step(fn, args)
    del out
    rl = roofline.extract(
        counter, model_flops=roofline.model_flops_estimate(cfg, shape),
        chips=1 if mesh is None else mesh.size)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "device": str(torch.device(device)),
        "reduced": reduced,
        "memory_analysis": mem,
        "roofline": rl.as_dict(),
        "matmul_flops": counter.matmul_flops,
        "exps": counter.exps,
        "kernels": dict(counter.kernels),
        "swa_variant": bool(cfg.swa_window and
                            specs.get_config(arch).swa_window == 0),
        "cards_needed": math.ceil(
            (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"])
            / roofline.HBM_BYTES),
    }
    if mesh is not None:
        rec.update(mesh=list(mesh.shape), multi_pod=multi_pod)
    if torch.device(device).type == "cuda":
        ms, peak = time_step(fn, args)
        rec.update(step_ms=ms, peak_allocated_bytes=peak,
                   roofline_share=max(rl.compute_s, rl.memory_s) * 1e3 / ms,
                   card=card_line())
    if verbose:
        _print(rec)
    return rec


def _print(rec):
    r, mem = rec["roofline"], rec["memory_analysis"]
    cut = f" reduced {rec['reduced']}" if rec["reduced"] else ""
    on = f" card 0 of mesh={rec['mesh']}" if "mesh" in rec else ""
    print(f"== {rec['arch']} x {rec['shape']} on {rec['device']}{on}{cut} "
          "==")
    print(f"   memory_analysis: {mem} -> {rec['cards_needed']} card(s)")
    print(f"   flops/chip={r['flops_per_chip']:.3e} "
          f"(matmul {rec['matmul_flops']:.3e}) "
          f"hbm/chip={r['hbm_bytes_per_chip']:.3e}")
    print(f"   terms: compute={r['compute_s']:.4f}s "
          f"memory={r['memory_s']:.4f}s "
          f"collective={r['collective_s']:.4f}s -> {r['dominant']} "
          f"({r['card']} at {r['power_limit_w']:.0f} W peaks)")
    if "mesh" in rec:
        print(f"   chips={r['chips']} collectives/chip: "
              f"{r['collective_bytes_per_chip']}")
    print(f"   kernels: {rec['kernels']}")
    uf = r["useful_flops_frac"]
    print(f"   MODEL_FLOPS/FLOPS = {uf:.3f}" if uf else
          "   (no flops counted)")
    if "step_ms" in rec:
        print(f"   step {rec['step_ms']:.3f} ms, peak "
              f"{rec['peak_allocated_bytes'] / 2 ** 30:.2f} GiB, roofline "
              f"share {rec['roofline_share']:.3f} on {rec['card']}")


def run_or_skip(arch, shape, **kw) -> dict:
    """run_one, or a record of why the step is skipped: the reference's
    shape skip, or on a mesh a model axis that would cut a query head
    (the port's shards hold whole heads: ``shardings.shard_heads``'
    ``HeadCut``). Any other refusal raises."""
    try:
        return run_one(arch, shape, **kw)
    except (ValueError, shardings.HeadCut) as e:
        if not (str(e).startswith(f"{arch} skips") or (
                isinstance(e, shardings.HeadCut)
                and kw.get("mesh") is not None)):
            raise
        print(f"SKIP: {e}")
        return {"arch": arch, "shape": shape, "skipped": str(e)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=SHAPES)
    ap.add_argument("--all", action="store_true",
                    help="every architecture x shape, in one process")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="count card 0's share on a (data, model) mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="a pod axis of 2 in front of --mesh (default "
                    "16x16)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")
    jobs = ([(a, s) for a in list_archs() for s in SHAPES] if args.all
            else [(args.arch, args.shape)])
    kw = dict(device=args.device, layers=args.layers, batch=args.batch)
    if args.mesh or args.multi_pod:
        kw.update(mesh=parse_mesh(args.mesh or "16x16", args.multi_pod),
                  multi_pod=args.multi_pod)
    recs = [run_or_skip(a, s, **kw) for a, s in jobs]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(recs if args.all else recs[0], f, indent=1)
    return recs


if __name__ == "__main__":
    main(sys.argv[1:])
