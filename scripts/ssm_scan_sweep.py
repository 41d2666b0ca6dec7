"""Sweep of the selective-scan kernel (#9, ``csrc/ssm_scan.cu``) on one card.

    python3 scripts/ssm_scan_sweep.py [--parent TREE] [--lanes 16:4,8]
        [--peak] [--shapes 1x1024,16x1024]
        [--out chiprun_out/ssm_scan_sweep.json]

Builds this tree's scan library (and, with ``--parent``, the same source of
another checkout, such as a ``git archive`` of the parent commit, with the
same flags), logs every instance's registers and spill stores (ptxas) and
the SASS instruction mix of the d_state 16 instances, checks each build
against the plain version at every shape (y within one bf16 ulp of the
largest output, the fp32 state within FP32_ATOL) and times it at Jamba's
widths (d_inner 8192, d_state 16, x bf16, dt fp32) as chip_smoke.py times
its kernels: CUDA events, mean of 10 calls, each after a 64 MB L2 flush.
Builds alternate in one process (parent, tree, tree, parent; each lane
variant after the tree's own), so compare them only within one run.
``--lanes DS:L1,L2`` also instantiates this tree's kernel at other lane
counts for that d_state (a tuning build; the library's own choice is
``kernels.ssm_scan.LANES``). The SASS of each build's d_state 16 kernels
goes to ``<out>.<build>.sass``. ``--peak`` also measures the ex2 rate a
plain ex2 loop reaches (per clock per SM, at the SM clock nvidia-smi
samples meanwhile) and the SM clock and power while this tree's scan
runs at b 16, s 1024. The default shapes are b 1, 4, 8, 16 at s 1024 and
the three joint prefills of chip_smoke.py's Jamba serve. Needs a CUDA
card and nvcc; writes its numbers to ``--out`` and exits 1 if a build
disagrees with the plain version anywhere.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs                                    # noqa: E402
from repro_torch.kernels import build, ops                 # noqa: E402
from repro_torch.kernels import ssm_scan as ss             # noqa: E402

SHAPES = ((1, 1024), (4, 1024), (8, 1024), (16, 1024),
          (1, 784), (7, 976), (8, 896))    # + the Jamba serve's prefills
DIN, DS = 8192, 16
ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_OP = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                 r"([A-Z][A-Z0-9_.]*)")


def _nvcc(src, so):
    """Compile `src` to library `so` with the port's flags; the ptxas
    report goes to so.log."""
    so.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    so.with_suffix(".log").write_text(out.stdout + out.stderr)
    if out.returncode:
        raise RuntimeError(f"nvcc {src}:\n{out.stdout}{out.stderr}")
    return so


def _lanes_source(lanes):
    """A translation unit that includes this tree's ssm_scan.cu and exports
    ssm_scan_fwd_lanes(..., lanes) over the (d_state, lanes) pairs asked,
    for x bf16 and dt fp32 (the timing types)."""
    cases = "\n".join(
        f"    case {ds * 100 + n}: return (int)ss::launch<{ds}, {n}, "
        "__nv_bfloat16, float>(x, dt, A, B, C, D, h0, y, h_out, b, s, din, "
        "(cudaStream_t)stream);" for ds, ls in lanes.items() for n in ls)
    return (f'#include "{build.CSRC / "ssm_scan.cu"}"\n'
            'extern "C" int ssm_scan_fwd_lanes(\n'
            '    const void* x, const void* dt, const float* A, const void* B,'
            '\n    const void* C, const float* D, const float* h0, void* y,\n'
            '    float* h_out, int b, int s, int din, int ds, int x_dtype,\n'
            '    int dt_dtype, void* stream, int lanes) {\n'
            '  if (x_dtype != 1 || dt_dtype != 0) return 1;\n'
            '  switch (ds * 100 + lanes) {\n' + cases + '\n'
            '    default: return 1;\n  }\n}\n')


# the SFU's reachable rate: 16 independent ex2 chains a thread, each ex2
# followed by one FMUL (the scan's own mix has ~6 fp32 instructions per
# ex2), 8 warps a block, 8 blocks an SM
EX2_PEAK = r"""
__global__ void __launch_bounds__(256) ex2_peak(float* out, int iters) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = threadIdx.x * 1e-3f + i * 1e-2f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float r;
      asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v[i]));
      v[i] = r * 0.3f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += v[i];
  if (s == 12345.f) out[0] = s;
}
extern "C" int ex2_peak_run(float* out, int blocks, int iters, void* st) {
  ex2_peak<<<blocks, 256, 0, (cudaStream_t)st>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _clock_during(fn, seconds=2.0):
    """Median SM clock (MHz) and power (W) that nvidia-smi samples every
    50 ms while fn() is called back to back for about `seconds`."""
    import statistics
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(1, int(seconds / max(time.perf_counter() - t0, 1e-4)))
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate()[0]
    rows = [tuple(map(float, r.split(","))) for r in text.strip().splitlines()
            if r.strip()]
    busy = rows[len(rows) // 4:] or rows       # past nvidia-smi's start
    return (statistics.median(r[0] for r in busy),
            statistics.median(r[1] for r in busy))


def _peak(sweep):
    """(ex2 per clock per SM reached, SM clock MHz, power W) of EX2_PEAK."""
    src = sweep / "ex2_peak.cu"
    src.write_text(EX2_PEAK)
    fn = ctypes.CDLL(str(_nvcc(src, sweep / "ex2_peak.so"))).ex2_peak_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.zeros(1, device="cuda")
    blocks, iters = 8 * sms, 4096

    def run():
        if fn(buf.data_ptr(), blocks, iters,
              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("ex2_peak launch failed")
    run()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(5):
        run()
    b.record()
    torch.cuda.synchronize()
    sec = a.elapsed_time(b) / 5e3
    mhz, watts = _clock_during(run)
    rate = blocks * 256 * iters * 16 / sec / sms / (mhz * 1e6)
    return rate, mhz, watts


def _entry(so, name="ssm_scan_fwd", lanes=None):
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.argtypes = ARGS + ([ctypes.c_int] if lanes else [])
    fn.restype = ctypes.c_int
    return fn if lanes is None else (lambda *a: fn(*a, lanes))


def _report(name, so, sass_file):
    """Registers and spills of every instance, the SASS op mix of the
    d_state 16 (bf16 or fp32 x, fp32 dt) instances, whose code goes to
    `sass_file`."""
    regs = cs._ptxas(so)
    for fn, (r, spill) in sorted(regs.items()):
        print(f"  ptxas [{name}] {fn}: {r} registers, {spill} bytes spill "
              "stores", flush=True)
    parts = re.split(r"\n\s*Function : (\S+)", cs._sass(so))
    mixes, dump = {}, []
    for fn, body in zip(cs._demangle(parts[1::2]), parts[2::2]):
        if not re.search(r"<\(int\)16, (?:\(int\)\d+, )?(?:__nv_bfloat16|"
                         r"float), float>", fn):
            continue
        dump.append(f"Function : {fn}\n{body}")
        ops_ = collections.Counter(m.group(1) for m in map(
            _OP.match, body.splitlines()) if m)
        mixes[fn] = dict(ops_.most_common())
        print(f"  sass [{name}] {fn}: {sum(ops_.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops_.most_common(40)),
              flush=True)
    Path(sass_file).write_text("\n".join(dump))
    return dict(ptxas={k: list(v) for k, v in regs.items()}, sass=mixes)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--lanes", action="append", default=[])
    ap.add_argument("--shapes")
    ap.add_argument("--peak", action="store_true")
    ap.add_argument("--out", default="chiprun_out/ssm_scan_sweep.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssm_scan_sweep: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    shapes = SHAPES if not a.shapes else tuple(
        tuple(map(int, x.split("x"))) for x in a.shapes.split(","))
    lanes = {int(ds): [int(n) for n in ls.split(",")]
             for ds, ls in (x.split(":") for x in a.lanes)}

    sweep = build.BUILD_DIR / "sweep"
    sweep.mkdir(parents=True, exist_ok=True)
    tree = build.build(["ssm_scan"])["ssm_scan"]
    entries = {"tree": _entry(tree)}
    out = dict(card=smi, shapes=shapes, builds={"tree": _report(
        "tree", tree, f"{a.out}.tree.sass")})
    if a.parent:
        so = _nvcc(Path(a.parent) / "src/repro_torch/csrc/ssm_scan.cu",
                   sweep / "parent.so")
        entries["parent"] = _entry(so)
        out["builds"]["parent"] = _report("parent", so,
                                          f"{a.out}.parent.sass")
    if lanes:
        src = sweep / "lanes.cu"
        src.write_text(_lanes_source(lanes))
        so = _nvcc(src, sweep / "lanes.so")
        out["builds"]["lanes"] = _report("lanes", so, f"{a.out}.lanes.sass")
        for ds, ls in lanes.items():
            for n in ls:
                entries[f"ds{ds} L{n}"] = _entry(so, "ssm_scan_fwd_lanes", n)
    order = (["parent"] if a.parent else []) + ["tree"] + [
        k for k in entries if k not in ("parent", "tree")]
    order += order[::-1]                       # parent, tree, tree, parent

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    lib = ss._lib
    out["ms"] = {}
    for b, s in shapes:
        g = cs._scan_inputs(gen, dev, b, s, DIN, DS, torch.bfloat16)
        fn = lambda: ops.ssm_scan(g["x"], g["dt"], g["A"], g["B"], g["C"],
                                  g["D"])
        with ops.backend("plain"):
            want = fn()
        bound, by = cs._bound(0, 0, exps=b * s * DIN * DS)
        times = collections.defaultdict(list)
        errs = {}
        try:
            for name in order:
                ss._lib = lambda e=entries[name]: e
                got = fn()
                torch.cuda.synchronize()
                try:
                    errs[name] = cs._compare_out(
                        "ssm_scan", f"{name} b={b} s={s}", got, want,
                        torch.bfloat16)
                except AssertionError as e:
                    print(f"  MISMATCH {e}", flush=True)
                    errs[name] = float("nan")
                times[name].append(cs._time_ms(fn, flush))
        finally:
            ss._lib = lib
        row = {k: sum(v) / len(v) for k, v in times.items()}
        out["ms"][f"{b}x{s}"] = dict(ms=row, each=dict(times), err=errs,
                                     sfu_bound_ms=bound)
        print(f"  time b={b} s={s}: " + ", ".join(
            f"{k} {v:.4f} ms ({'/'.join(f'{x:.4f}' for x in times[k])})"
            for k, v in row.items()) + f"; SFU bound {bound:.4f} ms; bf16 "
            "max abs err " + ", ".join(f"{k} {v:.3g}" for k, v in
                                       errs.items()), flush=True)
        del g, want
    if a.peak:
        rate, mhz, watts = _peak(sweep)
        g = cs._scan_inputs(gen, dev, 16, 1024, DIN, DS, torch.bfloat16)
        scan = _clock_during(lambda: ops.ssm_scan(
            g["x"], g["dt"], g["A"], g["B"], g["C"], g["D"]))
        out["peak"] = dict(ex2_per_clock_per_sm=rate, ex2_mhz=mhz,
                           ex2_watts=watts, scan_mhz=scan[0],
                           scan_watts=scan[1])
        print(f"  ex2 peak: {rate:.2f} ex2 per clock per SM at a median "
              f"{mhz:.0f} MHz, {watts:.0f} W; the tree's scan at b=16 "
              f"s=1024 runs at a median {scan[0]:.0f} MHz, {scan[1]:.0f} W",
              flush=True)
        del g
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"card: {smi}; wrote {a.out}", flush=True)
    if any(v != v for r in out["ms"].values() for v in r["err"].values()):
        raise SystemExit("ssm_scan_sweep: a build disagrees with the plain "
                         "version")


if __name__ == "__main__":
    main()
