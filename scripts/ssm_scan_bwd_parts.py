"""Where the selective scan's backward kernel (#9 bwd, ``csrc/ssm_scan_bwd.cu``)
spends its time, on one card.

    python3 scripts/ssm_scan_bwd_parts.py [--rounds 2]

Builds this tree's backward library as it is and in variants that each
leave one part of the kernel out (so their gradients are wrong; only their
times mean anything): the chunk's first forward walk (the piece
checkpoints), the piece's second walk (the sub-piece checkpoints), the
sub-pieces' recompute and backward step, the sum of dB / dC over the
block's channels, and the barrier before that sum. Times each at Jamba's
layer width (b 4, s 1024, d_inner 8192, d_state 16, x bf16, dt fp32) as
chip_smoke.py times its kernels (CUDA events, mean of 10 calls, each after
a 64 MB L2 flush), all builds in turn, `--rounds` times, in one process;
a part's cost is the whole kernel's time less its variant's. Needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs                                    # noqa: E402
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.kernels import ssm_scan as ss             # noqa: E402

# variant: (what it leaves out, its SB_SKIP bits in ssm_scan_bwd.cu)
CUTS = {
    "whole": ("nothing", 0),
    "walk1": ("the chunk's forward walk", 1),
    "walk2": ("the piece's walk to its sub-pieces", 2),
    "back": ("the sub-pieces' recompute and backward step", 4),
    "reduce": ("the dB / dC sum over the channels", 8),
    "barrier": ("the barrier before that sum", 16),
}


def _variant_lib(skip):
    """The backward library built with SB_SKIP = skip."""
    return build.build(["ssm_scan_bwd"],
                       defines=[f"SB_SKIP={skip}"])["ssm_scan_bwd"]


def _use(so):
    """Make ssm_scan_bwd_cuda call the library at `so`."""
    lib = ctypes.CDLL(str(so))
    lib.ssm_scan_bwd_scratch.argtypes = [ctypes.c_int] * 4
    lib.ssm_scan_bwd_scratch.restype = ctypes.c_longlong
    lib.ssm_scan_bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.ssm_scan_bwd.restype = ctypes.c_int
    ss._bwd_lib = lambda: lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssm_scan_bwd_parts: needs a CUDA card")
    dev = torch.device("cuda")
    cs.log(f"card: {torch.cuda.get_device_name(0)}")
    with concurrent.futures.ThreadPoolExecutor(len(CUTS)) as pool:
        futs = {k: pool.submit(_variant_lib, skip)
                for k, (_, skip) in CUTS.items()}
        libs = {k: f.result() for k, f in futs.items()}
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    x = cs._bwd_scan_inputs(gen, dev)
    inputs = [x[n] for n in ("x", "dt", "A", "B", "C", "D", "h_ins",
                             "dy")]
    times = {k: [] for k in CUTS}
    for _ in range(args.rounds):
        for k, so in libs.items():
            _use(so)
            times[k].append(cs._time_ms(
                lambda: ss.ssm_scan_bwd_cuda(*inputs), flush))
    whole = sum(times["whole"]) / len(times["whole"])
    for k, (what, _) in CUTS.items():
        ms = sum(times[k]) / len(times[k])
        cs.log(f"  ssm_scan_bwd without {what}: {ms:.4f} ms "
               f"({', '.join(f'{t:.4f}' for t in times[k])}); the part "
               f"{whole - ms:.4f} ms")


if __name__ == "__main__":
    main()
