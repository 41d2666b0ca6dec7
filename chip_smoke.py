"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from the repository root (it puts ``src/`` on the path itself) and
needs one CUDA card, nvcc (``CUDA_HOME`` or /usr/local/cuda) and nothing of
JAX. Phases, each of which raises on failure:

  1. device and build: prints the card's name and power limit, turns TF32
     off, compiles every kernel of the port with nvcc (one process per
     source, in parallel) into build/repro_torch/, and logs for the flash,
     contiguous-decode and paged libraries each kernel's registers and
     spills and the counts of the SASS instructions that show how it runs
     (HGMMA, UTMALDG / UTMASTG, LDGSTS, HMMA, MOVM), for the paged kernels
     with a digest of each kernel's code; the paged context body must show
     wgmma and TMA without spills, with cp.async on bf16 pools and none on
     int8 / fp8 pools (and none on fp32 pools under bf16 q), the decode
     body of the paged decode and verify kernels (on bf16, int8 and fp8
     pools, and on pools of the other width) mma.sync and movmatrix in
     bf16 and no spills, and no attention.cuh body but the fp32 one may be
     left;
     the scan's 12 kernels (logged with their registers and digests)
     exponentials, lane shuffles and cp.async copies, and no spills;
     every kernel of the previous tree (chip_smoke_sass.json)
     must keep its digest or be named there as gone or moved, and why;
  2. kernels against their plain PyTorch versions on the card, at
     Llama-2-70B attention widths (hq 64, hkv 8, d 128) and Jamba's (hq 32,
     hkv 8), at g 1 (hq = hkv 8), at the small head dims the CPU tests
     use and at the zoo's new GQA groups (granite-20b's hq 48 / hkv 1 / d
     128 and granite-moe-3b's hq 24 / hkv 8 / d 64), in bf16 and fp32
     (rows that see no key must come out as exact
     zeros; flash also at more key tiles than its ring holds, ragged s, 5
     queries and g = 1, contiguous decode also at S = 2048 with kv_len
     1..2048 at b = 16 and b = 1; paged decode and context at block sizes
     1, 2, 8, 12 and 16, decode also on 16 rows of 2048-key tables with
     kv_len 1..2048 and split-KV, context also with 256-token chunks at
     q_start up to 1792 and a 45-token chunk; verify at block sizes 16 and
     5 with T = 1, 5, 8 and 9 candidates, padded and dead rows, F2's
     kv_len == kv_start > 0, and rows long enough for split-KV), the three
     paged kernels also on int8 and fp8 pools through their quantized
     kernels (decode at the same five block sizes, context and verify at 16
     and 5, verify also at g 16, context also with 65 rows past the
     ranking's capacity), and the selective
     scan at Jamba's widths (d_inner 8192, d_state 16), the CPU tests' and
     ragged ones (d_inner 200, 24, 100: part-filled last blocks,
     element-wise loads) (output and final state); flash (#1) and the
     contiguous decode (#8) also at h2o-danube-1.8b's widths (hq 32, hkv
     8, head dim 80) on all their cases and on its own: a 4096-token
     window on 4600 keys with kv_start, a window shorter than a key tile,
     a ragged s with a dead row; the 4096-slot ring read whole and part
     filled, a 4672-position cache with kv_start and a dead row; then
     timed at the serving path's shapes (the scan at b 16 and b 1; #1 and
     #8 also at the h2o-danube serve's: q (4, 4604, 32, 80) under the
     window with kv_start 0..4, and one decode step on a full 4096-slot
     ring) beside their bound, their plain version and, where one PyTorch
     call computes the same function (flash and contiguous decode),
     ``F.scaled_dot_product_attention``; #1-#4 and #7 also at
     granite-20b's serve shapes (g 48) and #1, #2, #5, #6 and #7 at
     granite-moe-3b's (g 3); #2, #3 and #4 also on pools of the other width
     (K2: bf16 pools under fp32 q, fp32 pools holding bf16 values under
     bf16 q) on the ragged, null-table, split-KV and dead-row cases at
     block sizes 16 and 5, g 8 (d 128 and 64), g 48 and g 3, and timed at
     phase 3's shapes;
  3. serving at the full width of llama2-70b in bf16 (depth cut to 4 of 80
     layers, seeded random weights) through the asymmetric 2-stage paged
     pipeline: after a short warm-up serve, a synthetic workload (cold
     joint prefill + decode), a shared-prefix workload (prefix caching +
     chunked prefill), and the synthetic workload under speculative
     decoding twice, with the n-gram proposer and with a self-draft (the
     draft model is the target: a second copy of its weights), then three
     quantized serves: the shared-prefix workload on int8 pages with the
     first and last layers at bf16, the synthetic one on fp8 pages under
     n-gram speculation, and the synthetic one with int8 weights. Launch
     counters are zeroed before each serve and read after it, and every
     kernel of that path must have run at least layers x steps times (on
     quantized pools: the quantized kernels on the quantized layers, the
     unquantized ones on the guard layers only). The synthetic,
     shared-prefix, n-gram, quant-int8 and quant-fp8-ngram serves run once
     more with their paged decode, context, verify, quantized context and
     decode, and quantized verify calls sampled, to log those kernels'
     errors on their own inputs beside the bf16 floor. The synthetic,
     shared-prefix, self-draft, quant-int8, quant-fp8-ngram and quant-w8
     serves run once more under torch.profiler for a breakdown of device
     time.
     Then the hybrid path: jamba-v0.1-52b at full width in bf16 (depth
     cut to one 8-layer period of 32: seven Mamba layers, one attention
     layer, MoE with 16 experts top-2 on every other layer; seeded random
     weights)
     serves the synthetic workload through the same [3, 5] pipeline, whose
     first stage holds only Mamba layers (the (b, s) of each scan launch
     logged); the selective scan must run on all seven Mamba layers of
     every prefill, flash attention on every
     prefill and paged decode on every decode iteration; profiled too;
  4. engine parity in fp32: llama2-70b at full width (2 layers) on the
     same workloads, speculative ones included, and the synthetic and
     shared-prefix ones on int8 and fp8 pages and n-gram speculation on
     int8 pages; jamba-v0.1-52b at full width (one period) on the
     synthetic workload; each zoo configuration of phase 7 at full width
     (2 layers; xlstm-125m one 4-layer period) on the synthetic workload;
     llama2-70b's synthetic, shared-prefix and n-gram workloads also on
     bf16 pools (K2). Served through the kernels and through the plain
     versions, they must give identical tokens and ServeStats counters,
     and the speculative serves must give plain greedy decode's tokens.
     Then llama2-70b in bf16 (4 layers) on fp32 pools through the kernels,
     phase 3's synthetic, shared-prefix and n-gram workloads, each path's
     kernels launched layers x steps times;
  5. schedule -> plan -> from_config -> serve: the port's scheduler plans
     the full 80-layer llama2-70b for the launcher's paged settings on the
     case-study pool and for a shared-prefix workload (prefix caching,
     256-token chunks) on the half-price pool; each plan is scaled to 8
     layers at published widths (bf16), built by
     ``InferenceEngine.from_config`` and serves its config's Poisson
     workload on the wall clock. Every request must finish with its
     tokens, the first serve must run #1 and #2, the second #3 and #2.
     Then ``python -m repro_torch.launch.serve`` (llama2-70b --reduced,
     paged) runs in a subprocess on the card and must exit 0 with its
     assignment and summary lines, once more with ``--kv-dtype bf16`` (the
     reduced fp32 model on bf16 pools), and on granite-8b at full size
     (bf16) with ``--kv-dtype fp32``;
  6. the launcher's defaults (``phase_danube``): ``python -m
     repro_torch.launch.serve`` with no flags serves h2o-danube-1.8b at
     full width and depth in bf16 (static batching after the reference's
     warning, contiguous caches, the 4096-token window's ring); then 8
     prompts of 4600..4604 tokens and 64 new tokens each in static
     batches of 4 (#1 with the window engaged, #8 on the wrapped ring;
     profiled), the same in fp32 through the kernels and the plain
     versions (equal tokens, or a part at a near-tie whose margin is
     reported), and llama2-70b (4 layers) on the contiguous layout under
     continuous and under static batching (#1 and #8 only);
  7. the rest of the slot-mode zoo (``phase_zoo``) at full width in bf16,
     seeded weights, through a 2-stage paged pipeline, one model at a
     time: granite-20b (12 of 52 layers; MQA, g 48) serving phase 3's
     synthetic, shared-prefix and n-gram workloads, granite-moe-3b-a800m
     (8 of 32; g 3, 40 experts top-8) synthetic, shared-prefix and
     shared-prefix on int8 pages, codeqwen1.5-7b (all 32; q/k/v bias)
     synthetic and shared-prefix, phi3.5-moe-42b-a6.6b (8 of 32 layers:
     the whole model does not fit the card in bf16) and xlstm-125m (all
     12; no kernel, recurrent slot rows only) synthetic; every kernel of
     a serve's path must run layers x steps times; granite-20b's and
     granite-moe's synthetic serves profiled. Then ``python -m
     repro_torch.launch.serve --arch granite-moe-3b-a800m --reduced`` on
     the paged layout in a subprocess;
  8. the multi-replica features and observability: (a) llama2-70b at
     full width, 2 layers, fp32, two replicas with stage splits [1, 1]
     and [2], through the kernels and the plain versions, KVSAN off and
     on: a disaggregated serve (replica 0 prefills, replica 1 decodes)
     gives the colocated serve's tokens, migrates every request once and
     ships blocks x bytes per block; two prompt families of 1024 shared +
     64 unique tokens, with prefix caching, host tiers and the cluster
     prefix directory over pools that cannot hold both families' shared
     blocks, give the untiered serve's tokens while spilling to the host
     and promoting or fetching back; KVSAN stays silent and every counter
     is the kernels' through the plain versions; (b) llama2-70b at full
     width in bf16 (4 layers), replicas [1, 3] and [4]: phase 3's 16 x 32
     synthetic serve colocated and disaggregated (#1 and #2 must run,
     every request migrates), the two families tiered and clustered (#3
     must run; spills, and promotions or fetches), and one colocated
     serve traced on the wall clock into a metrics registry (the trace
     must validate with serve, queue_wait, iteration, prefill and decode
     spans, and count every request); (c) the launcher with prefix
     caching, ``--disaggregate``, ``--host-mem-gb``, ``--cluster-prefix``,
     ``--kvsan``, ``--trace-out``, ``--metrics-out`` and ``--calibrate``
     in a subprocess (roles, host-tier blocks and the calibration table
     printed; trace and metrics under build/phase8/), then ``python -m
     repro_torch.obs.report`` on them;
  9. online rescheduling and the encoder-decoder and VLM families: (a)
     llama2-70b at full width, 2 layers, fp32, on the chaos topology (two
     replicas whose stage splits cross), paged with chunked prefill and
     KVSAN on, on fp32, int8 and fp8 pools, through the kernels and the
     plain versions: replica 1 killed mid-prefill and mid-decode, and a
     live role re-split mid-decode (a drift detector fires, decoding slots
     move with their pages, scales and emitted tokens) each give the
     streams of the serve without a controller, leak no page, orphan and
     re-dispatch or move requests, and the same counters and controller
     events through both; #5 and #6 run on quantized pools; (b) the same
     kill and re-split in bf16 on llama2-70b (4 layers, replicas [1, 3]
     and [4], phase 3's 16 x 32 synthetic workload): every request
     finishes, #1 and #2 run; walls and the streams equal to the serve
     without a controller logged; (c) whisper-base (6 + 6 layers, 1500
     seeded frames) and paligemma-3b (18 layers, 256 seeded image
     embeddings) at full width in bf16 through
     ``AsymmetricPipeline.generate(batch_extras=)`` on a 2-stage split (4
     prompts of 32 tokens, 32 new): #1 on every encoder layer, decoder
     prefill and cross-attention, #8 on every decoder layer and step,
     counted exactly; both at 2 layers in fp32 through the kernels and the
     plain versions (equal tokens, prefill logits within 2e-4); (d) #1 at
     head dim 256 and on the cross shapes (1 and 37 queries against 1500
     keys, the 1500 x 1500 encoder), #8 at head dim 256, against their
     plain versions in bf16 and fp32, then timed at the serving shapes;
 10. training through the backward kernels: (a) llama2-70b at full width,
     2 layers, fp32, batch 2 x 512, and (b) jamba-v0.1-52b reduced, fp32,
     three steps of batch 2 x 300 (three scan chunks): each step's loss
     and gradients through the kernels and through the plain versions
     from the same weights (loss within 1e-5 relative, every gradient
     leaf within 1e-4 of its largest magnitude; the backward kernels
     launched by the kernel runs only), then the train step (AdamW)
     through the kernels; (c) #1's backward at (4, 1024, 64 / 8, 128),
     bf16 and fp32, causal and not, #1's training forward (o and lse)
     and backward at the zoo's g 48 / d 128 and g 3 / d 64 (groups that
     do not divide the bf16 body's 64-row warpgroups), at h2o-danube-1.8b's
     d 80 and paligemma-3b's d 256, and under a 256-key window on 1024
     keys at d 64, 80 and 128, and #9's at
     Jamba's layer width (4, 1024, 8192, 16) against their plain
     versions, two runs of each bit for bit, #1's bf16 backward against
     the fp32 plain version (F4), the tensor-core backward's edges and
     #9's at ragged s and odd din (BWD_EDGES, SCAN_BWD_EDGES), each
     backward also on NaN-filled scratch (the same bits),
     then both timed beside their bounds and plain versions (and SDPA's
     backward for #1), #1's training forward and backward also in the
     fp32 instances (e) launches, at d 80, d 256 and windowed d 64 (beside
     SDPA's forward and backward); (d) the
     memory the earlier phases left allocated must be under 1 GiB before
     any garbage collection (F8); llama2-70b at 4 layers, bf16, batch 4 x
     1024: one step's gradients with activation checkpointing
     (REMAT_TRAIN) on and off, bit for bit; five train steps through the
     kernels with it on and three with it off: step ms, tokens/s, peak
     memory (under PARENT_TRAIN_PEAK_GIB with it on), step 1's loss beside the plain bf16
     forward's, and one more step profiled; (e) ``launch.train --arch
     <a> --reduced --steps 2`` (its ``main``) for all eleven
     architectures on the card, once as ``python -m
     repro_torch.launch.train``, and h2o-danube-1.8b and paligemma-3b at
     full width (2 layers, fp32): loss and every gradient leaf through the
     kernels against the plain versions, as in (a).

``python3 chip_smoke.py --sass-of TREE OUT.json`` instead builds the
kernels of another checkout (the parent commit's ``git archive``) and
writes their SASS digests, which chip_smoke_sass.json records.

The last line of standard output is the JSON result
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches on the serving paths (phases 3, 5, 6, 7, 8 and 9), its
error against the plain version and its times, #1 and #8 once more at
head dim 80 with phase 6's launches and the times at its shapes, #1-#4
at g 48 and #1, #2, #5, #6 at g 3 with phase 7's granite-20b and
granite-moe-3b launches and the times at their shapes (#7 at both widths
is timed and logged; no serve launches it there), and #1 at head dim 256
and on whisper's cross shapes and #8 at head dim 256 with phase 9 (c)'s
launches and the times at their shapes, and the two backward kernels with
phase 10's train steps' launches and the times at (c)'s shapes; #2-#4 on
pools of the other width with phase 4's serves on them, and #1's training
forward and backward at d 80, d 256 and windowed with phase 10 (e)'s
launches there.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12          # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12           # fp32 outside the tensor cores
SFU_EX2_PER_CLOCK = 16            # ex2 per clock per SM, compute cap. 9.0
FP32_ATOL = 2e-5                  # scripts/smoke_serving.py:93
DEVICE = "cuda"

KERNEL_INFO = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:77"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:69"),
    "paged_context_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                "src/repro/kernels/paged_attention.py:267"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:63"),
    "paged_verify_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:424"),
    "paged_decode_attention_quant": (
        "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:165"),
    "paged_context_attention_quant": (
        "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:359"),
    "paged_verify_attention_quant": (
        "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:438"),
    "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:54"),
    # the backward kernels replace the reference's hand-written VJPs (XLA
    # custom VJPs around #1's and #9's functions, not Pallas kernels)
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/ops.py:185"),
    "ssm_scan_bwd": ("src/repro_torch/csrc/ssm_scan_bwd.cu",
                     "src/repro/kernels/ops.py:609"),
}


def log(*a):
    print(*a, flush=True)


_T0 = time.perf_counter()


def mark(what):
    """Log how far into the script `what` ended."""
    log(f"  ({what} done {time.perf_counter() - _T0:.1f} s into the script)")


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------

def phase_device_and_build():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    log(f"built {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s under {build.BUILD_DIR}")
    # one cuobjdump a library, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(_sass, libs.values()))
    log(f"disassembled them in {time.perf_counter() - t0:.1f}s")
    for name, so in libs.items():
        report = so.with_suffix(".log")
        if report.exists():
            text = report.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = re.findall(r"(\d+) bytes spill stores", text)
            log(f"  ptxas {name}: {len(regs)} kernels, {min(regs)}-"
                f"{max(regs)} registers, {sum(int(x) > 0 for x in spills)} "
                f"with spill stores (at most {max(map(int, spills))} bytes)")
    sass = {name: log_kernel_build(name, libs[name])
            for name in ("flash_attention", "decode_attention")}
    if not (sass["flash_attention"]["HGMMA"]
            and sass["flash_attention"]["UTMALDG"]):
        raise AssertionError("the flash library has no wgmma or no TMA load: "
                             f"{sass['flash_attention']}")
    check_paged_build(libs["paged_attention"])
    check_scan_build(libs["ssm_scan"])
    check_bwd_build(libs)
    check_sass_against_parent(libs)
    return smi


def log_kernel_build(name, so):
    """Registers and spills of each kernel of library `name` (ptxas), and
    how many of its SASS instructions are warpgroup MMAs (HGMMA), TMA loads
    and stores (UTMALDG, UTMASTG), cp.async copies (LDGSTS), mma.sync
    (HMMA) and matrix transposes (MOVM), from cuobjdump -sass."""
    for fn, (regs, spill) in _ptxas(so).items():
        log(f"  ptxas {name} {fn}: {regs} registers, {spill} bytes spill "
            "stores")
    counts = _sass_counts(_sass(so))
    log(f"  sass {name}: " + ", ".join(f"{op} {n}" for op, n in
                                        counts.items()))
    return counts


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "LDGSTS", "HMMA", "MOVM")


@functools.lru_cache(maxsize=None)
def _sass(so):
    """cuobjdump -sass of a library, once per library file."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout


def _sass_counts(text):
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in SASS_OPS}


def _demangle(names):
    """C++ names as cu++filt prints them (unchanged without it)."""
    from repro_torch.kernels import build
    filt = os.path.join(os.path.dirname(build.nvcc()), "cu++filt")
    if not names or not os.path.exists(filt):
        return list(names)
    return subprocess.run([filt], input="\n".join(names), capture_output=True,
                          text=True, check=True).stdout.split("\n")[
                              :len(names)]


@functools.lru_cache(maxsize=None)
def sass_functions(so):
    """{kernel name: (SASS op counts, digest)} of a library, once per
    library file (callers only read it): the digest
    hashes the kernel's instructions (addresses and encodings left out), so
    two builds of the same kernel code give the same digest."""
    import hashlib
    parts = re.split(r"\n\s*Function : (\S+)", _sass(so))
    out = {}
    for name, body in zip(_demangle(parts[1::2]), parts[2::2]):
        code = "\n".join(
            " ".join(line.split()) for line in
            (re.sub(r"/\*[^*]*\*/", "", x) for x in body.splitlines())
            if line.strip() and not line.strip().startswith("."))
        out[name] = (_sass_counts(body),
                     hashlib.sha256(code.encode()).hexdigest()[:12])
    return out


def _ptxas(so):
    """{kernel name: (registers, spill store bytes)} from nvcc's
    -Xptxas=-v report of a library."""
    found = re.findall(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
        r"Used (\d+) registers", so.with_suffix(".log").read_text(),
        flags=re.S)
    return {name: (int(regs), int(spill)) for name, (_, spill, regs) in
            zip(_demangle([x[0] for x in found]), found)}


def check_paged_build(so):
    """The paged library's kernels, one line each: registers, spills, SASS
    counts and a digest of the code. The bodies must show their
    instructions: the context body (pc::context_fwd) HGMMA and TMA loads
    without spills, with cp.async (LDGSTS) on bf16 pools and none on int8 /
    fp8 pools (#6), whose tiles the producer widens; the decode body
    (dk::decode_fwd: #2 on dk::Params, #4 on dk::VParams, #5 and #7 on
    dk::QParams / dk::QVParams of int8 and fp8, #2 and #4 on dk::MParams /
    dk::MVParams of pools of the other width) without spills, with HMMA
    and MOVM in bf16. Of attention.cuh only the fp32 scalar body is left:
    no mma.sync body (attn_fwd_mma), no bf16 instance and no second merge
    launch (combine_splits)."""
    funcs = sass_functions(so)
    regs = _ptxas(so)
    total = {op: sum(c[op] for c, _ in funcs.values()) for op in SASS_OPS}
    log(f"  sass paged_attention: {len(funcs)} kernels, " + ", ".join(
        f"{op} {n}" for op, n in total.items()))
    for name, (counts, digest) in sorted(funcs.items()):
        r, spill = regs.get(name, ("?", "?"))
        log(f"  sass paged_attention {name}: {r} registers, {spill} bytes "
            f"spill stores, " + ", ".join(f"{op} {n}" for op, n in
                                          counts.items() if n)
            + f"; digest {digest}")
    context = [n for n in funcs if n.startswith("void pc::context_fwd")]
    decode = [n for n in funcs if n.startswith("void dk::decode_fwd")]
    quant = [n for n in decode if "dk::QParams" in n or "dk::QVParams" in n]
    mixed = [n for n in decode if "dk::MParams" in n or "dk::MVParams" in n]
    # context: 3 head dims x (bf16, int8, fp8 and fp32 pools); decode: 3
    # head dims x (bf16 PAGED16, bf16 PAGED, fp32 PAGED) x (#2, #4, and #5,
    # #7 on int8 and on fp8 pools), and #2, #4 on pools of the other width
    # (fp32 pools under bf16 PAGED16 and PAGED, bf16 pools under fp32)
    if len(context) != 12 or len(decode) != 72 or len(quant) != 36 \
            or len(mixed) != 18:
        raise AssertionError(f"paged library: {len(context)} context and "
                             f"{len(decode)} decode kernels ({len(quant)} "
                             f"quantized, {len(mixed)} of the other width), "
                             "expected 12, 72 (36, 18)")
    for n in context:
        c = funcs[n][0]
        gathers = bool(c["LDGSTS"]) == n.startswith(
            "void pc::context_fwd<__nv_bfloat16")
        if not (c["HGMMA"] and c["UTMALDG"] and gathers) or \
                regs.get(n, (0, 0))[1]:
            raise AssertionError(f"{n}: {c}, spills {regs.get(n)}")
    left = [n for n in funcs if n.startswith(
        ("void rt::attn_fwd_mma", "void rt::attn_fwd<__nv_bfloat16",
         "void rt::combine_splits"))]
    if left:
        raise AssertionError(f"attention.cuh bodies left: {left}")
    for n in decode:
        c = funcs[n][0]
        if regs.get(n, (0, 0))[1] or (
                n.startswith("void dk::decode_fwd<__nv_bfloat16")
                and not (c["HMMA"] and c["MOVM"])):
            raise AssertionError(f"{n}: {c}, spills {regs.get(n)}")
    return funcs


SCAN_OPS = ("MUFU.EX2", "SHFL.BFLY", "LDGSTS")


def check_scan_build(so):
    """The scan library's 24 kernels (d_state 4 / 8 / 16 x x, dt in fp32 /
    bf16, serving and training's STATES instances), one line each:
    registers, spills, its exponentials (MUFU.EX2), the lane tree's
    shuffles (SHFL.BFLY), its cp.async copies (LDGSTS) and a digest of the
    code. None may spill, and each must show all three."""
    regs = _ptxas(so)
    parts = re.split(r"\n\s*Function : (\S+)", _sass(so))
    bodies = dict(zip(_demangle(parts[1::2]), parts[2::2]))
    digests = sass_functions(so)
    scan = sorted(n for n in bodies
                  if n.startswith("void ss::ssm_scan_kernel"))
    if len(scan) != 24:
        raise AssertionError(f"scan library: {len(scan)} kernels, expected "
                             "24")
    for n in scan:
        counts = {op: len(re.findall(rf"\b{re.escape(op)}\b", bodies[n]))
                  for op in SCAN_OPS}
        r, spill = regs.get(n, ("?", "?"))
        log(f"  sass ssm_scan {n}: {r} registers, {spill} bytes spill "
            "stores, " + ", ".join(f"{op} {k}" for op, k in counts.items())
            + f"; digest {digests[n][1]}")
        if spill != 0 or not all(counts.values()):
            raise AssertionError(f"{n}: {counts}, spills {spill}")


def check_bwd_build(libs):
    """The backward libraries' kernels, one line each: registers, spills,
    SASS counts and a digest. #1's backward: 24 SIMT kernels (fb::, pass
    1-3 x fp32 / bf16 x d 64, 80, 128, 256) and 6 of the tensor-core body
    (fbh::, pass 1-3 x d 64, 128), whose dK / dV and dQ kernels must show
    warpgroup MMA (HGMMA) and TMA loads; #9's: 12 sb::ssm_bwd_lanes (d_state
    4 / 8 / 16 x x, dt in fp32 / bf16), each with its exponentials
    (MUFU.EX2) and cp.async copies (LDGSTS), and 4 fixed-order reductions.
    No kernel of the tensor-core body or of #9's may spill."""
    want = {"flash_attention_bwd": {"void fb::": 24, "void fbh::": 6},
            "ssm_scan_bwd": {"void sb::ssm_bwd_lanes": 12,
                             "void sb::ssm_bwd_reduce": 4}}
    for lib, prefixes in want.items():
        so = libs[lib]
        regs = _ptxas(so)
        parts = re.split(r"\n\s*Function : (\S+)", _sass(so))
        bodies = dict(zip(_demangle(parts[1::2]), parts[2::2]))
        funcs = sass_functions(so)
        got = {pre: sorted(n for n in funcs if n.startswith(pre))
               for pre in prefixes}
        if {pre: len(n) for pre, n in got.items()} != prefixes \
                or len(funcs) != sum(prefixes.values()):
            raise AssertionError(f"{lib}: {len(funcs)} kernels, "
                                 f"{ {p: len(n) for p, n in got.items()} }"
                                 f", expected {prefixes}")
        for n in sorted(funcs):
            counts = dict(funcs[n][0])
            counts["MUFU.EX2"] = len(re.findall(r"MUFU\.EX2",
                                                bodies.get(n, "")))
            r, spill = regs.get(n, ("?", "?"))
            log(f"  sass {lib} {n}: {r} registers, {spill} bytes spill "
                "stores, " + ", ".join(f"{op} {k}" for op, k in
                                       counts.items() if k)
                + f"; digest {funcs[n][1]}")
            if n.startswith("void fb::"):
                continue  # the SIMT body: checked against its parent digest
            need = ()
            if n.startswith(("void fbh::dkdv_kernel", "void fbh::dq_kernel")):
                need = ("HGMMA", "UTMALDG")
            elif n.startswith("void sb::ssm_bwd_lanes"):
                need = ("MUFU.EX2", "LDGSTS")
            if spill != 0 or not all(counts[op] for op in need):
                raise AssertionError(f"{n}: {counts}, spills {spill}")


# the previous tree's SASS digests (sass_functions), which phase 1 holds
# this build's against: every kernel kept, or gone, or moved with a reason
PARENT_SASS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chip_smoke_sass.json")


def _nvcc_release():
    from repro_torch.kernels import build
    out = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def check_sass_against_parent(libs):
    """Each kernel of the previous tree (PARENT_SASS, under this tree's
    names: "renamed" maps a name whose template arguments this tree
    extended to its new name) against this build: the same digest (kept),
    absent (gone), or another digest (moved). Gone and moved kernels must
    be named in the file with the reason; with another nvcc than the
    file's the digests are not comparable, and only the counts are logged.
    The kernels this tree added ("added") are logged against the digests
    recorded for them."""
    with open(PARENT_SASS) as f:
        parent = json.load(f)
    same_tool = _nvcc_release() == parent["nvcc"]
    renamed = parent.get("renamed", {})
    kept, changed = 0, []
    for lib, digests in parent["digests"].items():
        funcs = sass_functions(libs[lib])
        for name, digest in digests.items():
            now = funcs.get(renamed.get(name, name), (None, None))[1]
            if now == digest:
                kept += 1
                continue
            why = parent["changed"].get(name)
            changed.append(name)
            log(f"  sass vs {parent['commit']}: {name} "
                f"{'gone' if now is None else 'moved'} ({why})")
            if why is None and same_tool:
                raise AssertionError(f"{name}: SASS digest {now} against the "
                                     f"previous tree's {digest}, no reason "
                                     f"given in {PARENT_SASS}")
    log(f"  sass vs {parent['commit']}: {kept} kernels keep their digest "
        f"({len(renamed)} of them under a new name), {len(changed)} gone or "
        "moved" + ("" if same_tool else f" (nvcc differs: {parent['nvcc']!r}"
                   ", digests not comparable)"))
    for lib, digests in parent.get("added", {}).items():
        funcs = sass_functions(libs[lib])
        same = sum(funcs.get(n, (None, None))[1] == d
                   for n, d in digests.items())
        missing = [n for n in digests if n not in funcs]
        if missing:
            raise AssertionError(f"{lib}: added kernels not built: "
                                 f"{missing}")
        log(f"  sass {lib}: {len(digests)} kernels added since "
            f"{parent['commit']}, {same} with their recorded digest")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions, then timed
# ---------------------------------------------------------------------------

def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _bf16_tol(want):
    # kernel and plain version both accumulate in fp32 and round once to
    # bf16; fp32 summation order may move a value across a rounding
    # boundary, so they may differ by one bf16 ulp (2^-7 relative to the
    # binade) at the largest output
    return float(want.float().abs().max()) * 2.0 ** -7 + 1e-6


def _compare(name, case, got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    tol = FP32_ATOL if dtype == torch.float32 else _bf16_tol(want)
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"{name} [{case}, {dtype}]: max abs err {err} "
                             f"> {tol}")
    return err


def _run_both(fn):
    from repro_torch.kernels import ops
    got = fn()
    with ops.backend("plain"):
        want = fn()
    return got, want


def flash_cases(gen, dev, dtype, hq=64, hkv=8, d=128):
    from repro_torch.kernels import ops
    b, s = 3, 77                             # not a multiple of 16
    q = _rand(gen, (b, s, hq, d), dtype, dev)
    k = _rand(gen, (b, s, hkv, d), dtype, dev)
    v = _rand(gen, (b, s, hkv, d), dtype, dev)
    kv_len = torch.tensor([60, 77, 77], device=dev)
    kv_start = torch.tensor([5, 0, 40], device=dev)   # row 2: dead queries
    yield "causal", lambda: ops.flash_attention(q, k, v), None
    yield "causal+window+kv_len+kv_start", lambda: ops.flash_attention(
        q, k, v, window=20, kv_len=kv_len, kv_start=kv_start), \
        lambda o: o[2, :40]
    yield "noncausal+kv_len", lambda: ops.flash_attention(
        q, k, v, causal=False, kv_len=kv_len), None
    # the bf16 body's edges: more key tiles than its ring has stages, a
    # ragged s that is no multiple of a 128-row tile, a 5-query prompt
    # (fewer rows than one warpgroup), and g = 1 (hq = hkv)
    b, s = 2, 645
    q = _rand(gen, (b, s, hq, d), dtype, dev)
    k = _rand(gen, (b, s, hkv, d), dtype, dev)
    v = _rand(gen, (b, s, hkv, d), dtype, dev)
    kv_len = torch.tensor([645, 600], device=dev)
    kv_start = torch.tensor([0, 300], device=dev)     # row 1: dead queries
    yield "long s=645 causal", lambda: ops.flash_attention(q, k, v), None
    yield "long s=645 window+kv_len+kv_start", lambda: ops.flash_attention(
        q, k, v, window=200, kv_len=kv_len, kv_start=kv_start), \
        lambda o: o[1, :300]
    yield "long s=645 noncausal", lambda: ops.flash_attention(
        q, k, v, causal=False), None
    q5, k5, v5 = (_rand(gen, (3, 5, h, d), dtype, dev)
                  for h in (hq, hkv, hkv))
    yield "s=5", lambda: ops.flash_attention(q5, k5, v5), None
    q1 = _rand(gen, (b, 300, hkv, d), dtype, dev)
    yield "g=1 s=300", lambda: ops.flash_attention(
        q1, k[:, :300].contiguous(), v[:, :300].contiguous()), None


def window_cases(gen, dev, dtype, hq=32, hkv=8, d=80):
    """h2o-danube-1.8b's prefills (d 80, g 4): its 4096-token window on
    4600 keys with left padding (kv_start), a window shorter than a key
    tile, and a ragged s (no multiple of the 128-row tile) with a dead
    row."""
    from repro_torch.kernels import ops
    q, k, v = (_rand(gen, (1, 4600, h, d), dtype, dev)
               for h in (hq, hkv, hkv))
    yield "s=4600 window=4096 kv_start=4", lambda: ops.flash_attention(
        q, k, v, window=4096, kv_start=torch.tensor([4], device=dev)), None
    yield "s=4600 window=50", lambda: ops.flash_attention(
        q, k, v, window=50), None
    q, k, v = (_rand(gen, (3, 333, h, d), dtype, dev) for h in (hq, hkv, hkv))
    kv_start = torch.tensor([0, 3, 333], device=dev)     # row 2: dead
    yield "s=333 window=100 kv_start+dead", lambda: ops.flash_attention(
        q, k, v, window=100, kv_start=kv_start), lambda o: o[2]


def ring_cases(gen, dev, dtype, hq=32, hkv=8, d=80):
    """h2o-danube-1.8b's target decode (d 80, g 4): its 4096-slot ring read
    whole or part-filled (kv_len only, as the ring passes no kv_start), a
    full 4672-position cache with left padding (kv_start; row 3 dead), and
    a b = 1 row whose keys spread over the most splits."""
    from repro_torch.kernels import ops
    q = _rand(gen, (4, 1, hq, d), dtype, dev)
    k, v = (_rand(gen, (4, 4096, hkv, d), dtype, dev) for _ in range(2))
    yield "ring S=4096 kv_len=4096", lambda: ops.decode_attention(
        q, k, v, kv_len=torch.full((4,), 4096, device=dev)), None
    yield "ring S=4096 kv_len 1..4095", lambda: ops.decode_attention(
        q, k, v, kv_len=torch.tensor([1, 100, 2000, 4095], device=dev)), None
    yield "ring S=4096 b=1", lambda: ops.decode_attention(
        q[:1], k[:1], v[:1], kv_len=torch.tensor([4096], device=dev)), None
    k, v = (_rand(gen, (4, 4672, hkv, d), dtype, dev) for _ in range(2))
    yield "full S=4672 kv_start+dead", lambda: ops.decode_attention(
        q, k, v, kv_len=torch.tensor([4672, 4604, 300, 4], device=dev),
        kv_start=torch.tensor([0, 4, 200, 4], device=dev)), lambda o: o[3]


def _pool(gen, dev, dtype, n_blocks, bs, hkv, d, kv=None):
    """Random K/V page pools in `dtype`, and {} for the ops call; with
    `kv` ("int8" / "fp8") the pools are quantized rows and the dict holds
    their k_scale / v_scale. The null page's scales are 0, as in a fresh
    pool. kv "other": pools of the other width, bf16 under fp32 q, fp32
    under bf16 q holding bf16 values (what a bf16 model writes there)."""
    from repro_torch.models import quant
    kp = _rand(gen, (n_blocks, bs, hkv, d), dtype, dev)
    vp = _rand(gen, (n_blocks, bs, hkv, d), dtype, dev)
    if kv is None:
        return kp, vp, {}
    if kv == "other":
        other = (torch.float32 if dtype == torch.bfloat16
                 else torch.bfloat16)
        return (kp.to(torch.bfloat16).to(other),
                vp.to(torch.bfloat16).to(other), {})
    (kq, ks), (vq, vs) = (quant.quantize_kv_rows(t, kv) for t in (kp, vp))
    ks[0] = 0.0
    vs[0] = 0.0
    return kq, vq, dict(k_scale=ks, v_scale=vs)


def _tables(gen, dev, b, nb, n_blocks):
    """(b, nb) block tables over distinct random pages 1 .. n_blocks - 1."""
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)[:b * nb]
    return (perm + 1).reshape(b, nb).to(torch.int32)


# block sizes of the paged checks: the engines' 16, the CPU tests' 2, 4 and
# 8, and sizes that do not divide 16 (1, 12); both decode kernels at all of
# them, the quantized context and both verify kernels at 16 and 5
BLOCK_SIZES = (16, 1, 2, 8, 12)


def decode_cases(gen, dev, dtype, hq=64, hkv=8, d=128, kv=None):
    from repro_torch.kernels import ops
    for bs in BLOCK_SIZES if kv != "other" else (16, 5):
        # ragged lengths, free slots on all-null tables (one reading the
        # trash page, one with no live key) over 128-key tables
        nb = -(-128 // bs)
        kp, vp, sc = _pool(gen, dev, dtype, 6 * nb + 1, bs, hkv, d, kv)
        tbl = _tables(gen, dev, 6, nb, 6 * nb + 1)
        tbl[3] = tbl[5] = 0
        kv_len = torch.tensor([1, 17, nb * bs, 1, 33, 0], device=dev)
        q = _rand(gen, (6, 1, hq, d), dtype, dev)
        yield f"bs={bs} ragged+null-rows", lambda: ops.paged_decode_attention(
            q, kp, vp, tbl, kv_len=kv_len, **sc), lambda o: o[5]
        # split-KV over a 1600-key table: the short row has 2 live tiles and
        # more splits than that, so its trailing splits see no key
        nb = -(-1600 // bs)
        kp, vp, sc = _pool(gen, dev, dtype, 4 * nb + 1, bs, hkv, d, kv)
        tbl = _tables(gen, dev, 4, nb, 4 * nb + 1)
        tbl[3] = 0
        kv_len = torch.tensor([nb * bs, 40, 999, 0], device=dev)
        q = _rand(gen, (4, 1, hq, d), dtype, dev)
        yield f"bs={bs} long+splits", lambda: ops.paged_decode_attention(
            q, kp, vp, tbl, kv_len=kv_len, **sc), lambda o: o[3]
        # the serving tables' width: 16 rows of 2048-key tables, kv_len 1 to
        # 2048 (contiguous decode's S=2048 case), the last row a free slot
        nb = -(-2048 // bs)
        kp, vp, sc = _pool(gen, dev, dtype, 16 * nb + 1, bs, hkv, d, kv)
        tbl = _tables(gen, dev, 16, nb, 16 * nb + 1)
        tbl[15] = 0
        kv_len = torch.tensor([1, 2, 15, 16, 17, 63, 64, 65, 100, 511, 512,
                               1000, 1100, 2047, 2048, 0], device=dev)
        q = _rand(gen, (16, 1, hq, d), dtype, dev)
        yield (f"bs={bs} 16 rows kv_len 1..2048",
               lambda: ops.paged_decode_attention(
                   q, kp, vp, tbl, kv_len=kv_len, **sc), lambda o: o[15])
        del kp, vp, sc


def context_cases(gen, dev, dtype, hq=64, hkv=8, d=128, kv=None):
    from repro_torch.kernels import ops
    for bs in BLOCK_SIZES if kv is None else (16, 5):
        # C 37: page boundary, mid-page, short chunk, and an empty row
        # (dead queries) on 128-key tables
        nb = -(-128 // bs)
        kp, vp, sc = _pool(gen, dev, dtype, 4 * nb + 1, bs, hkv, d, kv)
        tbl = _tables(gen, dev, 4, nb, 4 * nb + 1)
        q = _rand(gen, (4, 37, hq, d), dtype, dev)
        q_start = torch.tensor([32, 21, 0, 0], device=dev)
        kv_len = q_start + torch.tensor([37, 20, 5, 0], device=dev)
        yield (f"bs={bs} C=37 boundary+midpage+dead",
               lambda: ops.paged_context_attention(
                   q, kp, vp, tbl, q_start=q_start, kv_len=kv_len, **sc),
               lambda o: o[3])
        # the serving chunk, C 256, at q_start up to 1792 of 2048-key
        # tables: many pages before it, one row ending mid-chunk, an empty
        # row
        nb = -(-2048 // bs)
        kp, vp, sc = _pool(gen, dev, dtype, 5 * nb + 1, bs, hkv, d, kv)
        tbl = _tables(gen, dev, 5, nb, 5 * nb + 1)
        q = _rand(gen, (5, 256, hq, d), dtype, dev)
        q_start = torch.tensor([0, 256, 1024, 1792, 0], device=dev)
        kv_len = q_start + torch.tensor([256, 200, 256, 256, 0], device=dev)
        yield (f"bs={bs} C=256 q_start..1792",
               lambda: ops.paged_context_attention(
                   q, kp, vp, tbl, q_start=q_start, kv_len=kv_len, **sc),
               lambda o: o[4])
        # C 45 (no multiple of 16): starts past several pages, mid-page, and
        # ends mid-page
        nb = -(-256 // bs)
        kp, vp, sc = _pool(gen, dev, dtype, 3 * nb + 1, bs, hkv, d, kv)
        tbl = _tables(gen, dev, 3, nb, 3 * nb + 1)
        q = _rand(gen, (3, 45, hq, d), dtype, dev)
        q_start = torch.tensor([3, 100, 0], device=dev)
        kv_len = torch.tensor([48, 130, 0], device=dev)
        yield (f"bs={bs} C=45 midpage", lambda: ops.paged_context_attention(
            q, kp, vp, tbl, q_start=q_start, kv_len=kv_len, **sc),
            lambda o: o[2])
        del kp, vp, sc
    if (hq, hkv, d) == (4, 1, 64):
        # more (row tile, row) units, 32 x 65, than the bf16 body ranks in
        # shared memory: its items then run row tiles longest first
        b, C, bs = 65, 1024, 16
        nb = -(-1536 // bs)
        kp, vp, sc = _pool(gen, dev, dtype, b * nb + 1, bs, hkv, d, kv)
        tbl = _tables(gen, dev, b, nb, b * nb + 1)
        q = _rand(gen, (b, C, hq, d), dtype, dev)
        q_start = torch.arange(b, device=dev) * 8
        kv_len = q_start + C
        kv_len[-1] = 0
        yield ("bs=16 C=1024 b=65 unranked", lambda:
               ops.paged_context_attention(q, kp, vp, tbl, q_start=q_start,
                                           kv_len=kv_len, **sc),
               lambda o: o[-1])


def contiguous_decode_cases(gen, dev, dtype, hq=64, hkv=8, d=128):
    from repro_torch.kernels import ops
    b, S = 5, 77                             # S not a multiple of 32
    q = _rand(gen, (b, 1, hq, d), dtype, dev)
    k = _rand(gen, (b, S, hkv, d), dtype, dev)
    v = _rand(gen, (b, S, hkv, d), dtype, dev)
    # ragged kv_len, kv_start > 0, and row 3 with no live key
    kv_len = torch.tensor([1, 40, 77, 30, 60], device=dev)
    kv_start = torch.tensor([0, 0, 13, 30, 45], device=dev)
    yield "ragged+kv_start+dead", lambda: ops.decode_attention(
        q, k, v, kv_len=kv_len, kv_start=kv_start), lambda o: o[3]
    yield "full", lambda: ops.decode_attention(q, k, v), None
    # a long cache: every row gets more splits than it has live tiles
    # (counted from its kv_start), so its trailing splits see no key
    S = 1500
    q = _rand(gen, (3, 1, hq, d), dtype, dev)
    k = _rand(gen, (3, S, hkv, d), dtype, dev)
    v = _rand(gen, (3, S, hkv, d), dtype, dev)
    kv_len = torch.tensor([1500, 900, 64], device=dev)
    kv_start = torch.tensor([700, 0, 0], device=dev)
    yield "long+splits", lambda: ops.decode_attention(
        q, k, v, kv_len=kv_len, kv_start=kv_start), None
    # the draft's cache width: S = 2048, kv_len from 1 to 2048, kv_start
    # > 0 on some rows, at b = 16 and at b = 1 (the most splits per row)
    S = 2048
    q = _rand(gen, (16, 1, hq, d), dtype, dev)
    k = _rand(gen, (16, S, hkv, d), dtype, dev)
    v = _rand(gen, (16, S, hkv, d), dtype, dev)
    kv_len = torch.tensor([1, 2, 15, 16, 17, 63, 64, 65, 100, 511, 512, 1000,
                           1100, 2047, 2048, 2048], device=dev)
    kv_start = torch.tensor([0, 1, 0, 3, 16, 0, 0, 64, 99, 0, 500, 0, 7, 0,
                             2000, 0], device=dev)
    yield "S=2048 b=16 kv_len 1..2048", lambda: ops.decode_attention(
        q, k, v, kv_len=kv_len, kv_start=kv_start), None
    yield "S=2048 b=1 full", lambda: ops.decode_attention(
        q[:1], k[:1], v[:1]), None
    yield "S=2048 b=1 kv_start=700", lambda: ops.decode_attention(
        q[:1], k[:1], v[:1], kv_len=kv_len[-1:],
        kv_start=kv_start[:1] + 700), None


def verify_cases(gen, dev, dtype, hq=64, hkv=8, d=128, kv=None):
    from repro_torch.kernels import ops

    def case(kp, vp, sc, tbl, T, kv_start, q_len):
        q = _rand(gen, (len(kv_start), T, hq, d), dtype, dev)
        start = torch.tensor(kv_start, device=dev)
        kv_len = start + torch.tensor(q_len, device=dev)
        return lambda: ops.paged_verify_attention(
            q, kp, vp, tbl, kv_start=start, kv_len=kv_len, **sc)

    # 128-key tables at the engines' block size and at one that does not
    # divide 16 (a key lookup each); row 2 is a free slot (all-null table,
    # kv_len 0: exact zeros)
    for bs in (16, 5):
        nb = -(-128 // bs)
        cap = nb * bs
        kp, vp, sc = _pool(gen, dev, dtype, 4 * nb + 1, bs, hkv, d, kv)
        tbl = _tables(gen, dev, 4, nb, 4 * nb + 1)
        tbl[2] = 0
        # T = 5 (k = 4): a full chunk, a padded one (3 padding candidates
        # that still see the committed keys) and a chunk ending at the
        # table's last position
        yield f"bs={bs} T=5 padded+dead", case(
            kp, vp, sc, tbl, 5, [32, 21, 0, cap - 5], [5, 2, 0, 5]), \
            lambda o: o[2]
        yield f"bs={bs} T=1", case(
            kp, vp, sc, tbl, 1, [36, 25, 0, cap - 1], [1, 1, 0, 1]), \
            lambda o: o[2]
        # T = 8 (one block's 8 columns at g 1, several column groups at
        # g > 1), ragged counts, and row 3 with kv_len == kv_start > 0: its
        # candidates see the committed keys, as the oracle's do (F2)
        yield f"bs={bs} T=8 ragged+F2", case(
            kp, vp, sc, tbl, 8, [40, 17, 0, 64], [8, 3, 0, 0]), \
            lambda o: o[2]
        # T = 9: more candidates than one block's columns at g 1
        yield f"bs={bs} T=9", case(
            kp, vp, sc, tbl, 9, [7, 100, 0, cap - 9], [9, 9, 0, 4]), \
            lambda o: o[2]
        del kp, vp, sc
    # rows long enough for several splits: kv_start up to the capacity of
    # 2048-key tables
    nb = 128
    kp, vp, sc = _pool(gen, dev, dtype, 4 * nb + 1, 16, hkv, d, kv)
    tbl = _tables(gen, dev, 4, nb, 4 * nb + 1)
    tbl[2] = 0
    yield "bs=16 T=5 long+splits", case(
        kp, vp, sc, tbl, 5, [2043, 1500, 0, 1100], [5, 4, 0, 5]), \
        lambda o: o[2]


def _quantized(cases):
    """The cases of a paged kernel on int8 and on fp8 pools (the ops calls
    then carry k_scale / v_scale and reach the quantized kernel)."""
    def quant_cases(gen, dev, dtype, **widths):
        for kv in ("int8", "fp8"):
            for case, fn, dead in cases(gen, dev, dtype, kv=kv, **widths):
                yield f"{kv} {case}", fn, dead
    return quant_cases


CASES = {"flash_attention": flash_cases,
         "paged_decode_attention": decode_cases,
         "paged_context_attention": context_cases,
         "decode_attention": contiguous_decode_cases,
         "paged_verify_attention": verify_cases,
         "paged_decode_attention_quant": _quantized(decode_cases),
         "paged_context_attention_quant": _quantized(context_cases),
         "paged_verify_attention_quant": _quantized(verify_cases)}


# h2o-danube-1.8b's own cases of #1 and #8 (its window, its ring), at its
# widths (d 80, g 4)
D80_CASES = {"flash_attention": window_cases,
             "decode_attention": ring_cases}


# the zoo's new GQA groups: granite-20b's MQA (48 query heads on one kv
# head of 128: one position fills 48 of a wgmma warpgroup's 64 rows, six
# head groups of 8 share the decode body's kv head) and granite-moe-3b's
# (24 on 8 kv heads of 64: 21 positions of 3 heads fill 63 rows)
ZOO_WIDTHS = (dict(hq=48, hkv=1, d=128), dict(hq=24, hkv=8, d=64))


# #2, #3 and #4 on pools of the other width than q's (K2): bf16 pools
# under fp32 q (an fp32 model's --kv-dtype bf16) and fp32 pools under bf16
# q (a bf16 model's --kv-dtype fp32), at g 8 (d 128 and 64), g 48 and g 3
MIXED_CASES = {"paged_decode_attention": decode_cases,
               "paged_context_attention": context_cases,
               "paged_verify_attention": verify_cases}
MIXED_WIDTHS = ({}, dict(hq=64, hkv=8, d=64), *ZOO_WIDTHS)
MIXED_TAGS = {torch.float32: "bf16-pool", torch.bfloat16: "fp32-pool"}


def check_mixed_widths(dev):
    """Phase 2 (K2): #2, #3 and #4 against their plain versions on pools of
    the other width (MIXED_CASES): ragged rows, null tables, split-KV and
    dead verify rows, block sizes 16 and 5; fp32 q within FP32_ATOL, bf16
    q within one bf16 ulp of the largest output (its fp32 pool holds bf16
    values, so the kernel's narrowing load is exact); rows that see no key
    exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(12)
    n = 0
    for name, cases in MIXED_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for widths in MIXED_WIDTHS:
                worst = 0.0
                for case, fn, dead in cases(gen, dev, dtype, kv="other",
                                            **widths):
                    got, want = _run_both(fn)
                    torch.cuda.synchronize()
                    worst = max(worst, _compare(
                        name, f"{MIXED_TAGS[dtype]} {case}", got, want,
                        dtype))
                    if dead is not None and torch.count_nonzero(dead(got)):
                        raise AssertionError(f"{name} [{case}, {dtype} q, "
                                             f"{MIXED_TAGS[dtype]}]: a row "
                                             "that sees no key is not zero")
                    n += 1
                log(f"  check {name} [{MIXED_TAGS[dtype]}] {dtype} q "
                    f"hq={widths.get('hq', 64)} hkv={widths.get('hkv', 8)} "
                    f"d={widths.get('d', 128)}: every case, max abs err "
                    f"{worst:.3g}")
    log(f"  check: {n} cases of #2, #3 and #4 on pools of the other width "
        "agree with their plain versions")


def check_kernels(dev, names=None):
    """Every kernel (of `names`, None: all) against its plain version:
    Llama-2-70B widths (g 8), Jamba's (hq 32, hkv 8: g 4), g 1 (hq = hkv
    8), the CPU tests' small head dims and the zoo's g 48 and g 3
    (ZOO_WIDTHS; both verify kernels also at g 16; #1 and #8 also at
    h2o-danube-1.8b's d 80, g 4, and on its window and ring cases), in
    bf16 and fp32, the paged kernels at several block sizes; the parts of
    a case that see no key must be exact zeros. Returns {kernel: max abs
    err over its fp32 checks}."""
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    dtypes = (torch.bfloat16, torch.float32)
    for name, cases in CASES.items():
        if names is not None and name not in names:
            continue
        runs = [(dt, widths, cases) for dt in dtypes
                for widths in ({}, dict(hq=32, hkv=8, d=128),
                               dict(hq=8, hkv=8, d=128),
                               dict(hq=4, hkv=2, d=32),
                               dict(hq=4, hkv=1, d=64), *ZOO_WIDTHS)]
        if name.startswith("paged_verify"):   # g 16: two head groups
            runs += [(dt, dict(hq=32, hkv=2, d=64), cases) for dt in dtypes]
        if name in D80_CASES:
            runs += [(dt, dict(hq=32, hkv=8, d=80), c)
                     for c in (cases, D80_CASES[name]) for dt in dtypes]
        for dtype, widths, run_cases in runs:
            for case, fn, dead in run_cases(gen, dev, dtype, **widths):
                got, want = _run_both(fn)
                torch.cuda.synchronize()
                err = _compare(name, case, got, want, dtype)
                if dead is not None and torch.count_nonzero(dead(got)):
                    raise AssertionError(f"{name} [{case}, {dtype}]: a row "
                                         "that sees no key is not zero")
                if dtype == torch.float32:
                    errs[name] = max(errs.get(name, 0.0), err)
                log(f"  check {name} [{case}] {dtype} "
                    f"hq={widths.get('hq', 64)} hkv={widths.get('hkv', 8)} "
                    f"d={widths.get('d', 128)}: max abs err {err:.3g}")
    return errs


def _scan_inputs(gen, dev, b, s, din, ds, dtype, dt_dtype=torch.float32,
                 h0=False):
    """Selective-scan inputs shaped like a Mamba layer's: dt log-uniform in
    [1e-3, 0.1] (the model's dt_bias range), A = -(1..ds) scaled per
    channel, D near 1, B and C of x's dtype; h0 a small random state."""
    u = torch.rand((b, s, din), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev) \
        * torch.exp(0.3 * torch.randn((din, 1), generator=gen, device=dev))
    return dict(x=_rand(gen, (b, s, din), dtype, dev), dt=dt.to(dt_dtype),
                A=A, B=_rand(gen, (b, s, ds), dtype, dev),
                C=_rand(gen, (b, s, ds), dtype, dev),
                D=1.0 + 0.1 * torch.randn((din,), generator=gen, device=dev),
                h0=(0.1 * torch.randn((b, din, ds), generator=gen, device=dev)
                    if h0 else None))


def _compare_out(name, case, got, want, dtype):
    """_compare for a kernel's output, or for the scan's (y, h_final): y
    at its dtype's tolerance, the float32 state at FP32_ATOL."""
    if not isinstance(got, tuple):
        return _compare(name, case, got, want, dtype)
    return max(_compare(name, case + " y", got[0], want[0], dtype),
               _compare(name, case + " h", got[1], want[1], torch.float32))


def check_scan(dev):
    """The selective scan against its plain version: Jamba's widths
    (d_inner 8192, d_state 16) at s in {1, 17, 144, 1024} and b in
    {1, 3, 16}, x bf16 with fp32 dt (the model's types) and all fp32, with
    and without h0, one case with bf16 dt; then the CPU tests' widths
    (d_inner 16 / 8 / 512, d_state 8 / 4 / 16) and ragged ones whose last
    block holds a part of a warp's channels (d_inner 200 at d_state 16, 24
    at d_state 4) or whose rows miss the 16-byte copies' alignment (d_inner
    100 at d_state 8: element-wise loads). Returns the max abs err of the
    fp32 checks."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    ss._lib()                # checks the library's lanes against ss.LANES
    log(f"  ssm_scan: {ss.THREADS}-thread blocks, a channel's state split "
        f"over lanes {ss.LANES} (d_state: lanes, as the library's own)")
    gen = torch.Generator(device=dev).manual_seed(2)
    runs = [(din, ds, s, b, dt_, h0)
            for din, ds in ((8192, 16),)
            for s in (1, 17, 144, 1024) for b in (1, 3, 16)
            for dt_ in (torch.bfloat16, torch.float32)
            for h0 in (False, True)]
    runs += [(din, ds, s, 3, dt_, h0)
             for din, ds in ((16, 8), (8, 4), (512, 16), (200, 16),
                             (24, 4), (100, 8))
             for s in (1, 17, 144)
             for dt_ in (torch.bfloat16, torch.float32)
             for h0 in (False, True)]
    runs.append((8192, 16, 144, 3, "bf16 dt", True))
    worst = 0.0
    for din, ds, s, b, dtype, h0 in runs:
        dt_dtype = torch.float32
        if dtype == "bf16 dt":
            dtype = dt_dtype = torch.bfloat16
        x = _scan_inputs(gen, dev, b, s, din, ds, dtype, dt_dtype, h0)
        fn = lambda: ops.ssm_scan(x["x"], x["dt"], x["A"], x["B"], x["C"],
                                  x["D"], h0=x["h0"])
        got, want = _run_both(fn)
        torch.cuda.synchronize()
        case = (f"b={b} s={s} din={din} ds={ds} dt {dt_dtype} "
                f"{'h0' if h0 else 'no h0'}")
        err = _compare_out("ssm_scan", case, got, want, dtype)
        if dtype == torch.float32:
            worst = max(worst, err)
        if s == 1024 or din != 8192:
            log(f"  check ssm_scan [{case}] {dtype}: max abs err {err:.3g}")
        del x, got, want
    log(f"  check ssm_scan: {len(runs)} cases agree (fp32 max abs err "
        f"{worst:.3g}, atol {FP32_ATOL}; bf16 y within one bf16 ulp of the "
        "largest output)")
    torch.cuda.empty_cache()
    return worst


def _sm_clock_hz():
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _time_ms(fn, flush, iters=10):
    """Mean device time of fn over `iters` calls, each after an L2 flush
    (the serving path meets every layer's pages cold). The card first
    spins for ~50 ms so that Python has enqueued every call before the
    first one starts: the events then time device work back to back, not
    the host's launch overhead between them."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for a, b in zip(starts, ends):
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / iters


def _bound(nbytes, flops, flop_rate=BF16_FLOP_PER_S, exps=0):
    """(ms, by): the larger of the bytes over HBM's rate, the operations
    over the peak rate of their type and the exponentials over the SFUs'
    (16 ex2 per clock per SM at the maximum SM clock)."""
    times = [(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
             (flops / flop_rate * 1e3, "operations")]
    if exps:
        sfu = (SFU_EX2_PER_CLOCK * _sm_clock_hz()
               * torch.cuda.get_device_properties(0).multi_processor_count)
        times.append((exps / sfu * 1e3, "exp (SFU)"))
    return max(times)


def timing_inputs(dev, gen):
    """Inputs at the shapes phase 3 gives each kernel (bf16, Llama-2-70B
    attention widths): a joint cold prefill of 16 prompts padded to 1024,
    a 16-slot decode step over 512..1040-token contexts in a 2049-block
    pool, a 4-row 256-token context chunk at 256-token offsets, a 16-slot
    draft decode step over 512..1100-token contexts of a 2048-wide
    contiguous cache, and a 16-slot verification of k + 1 = 5 candidates
    at committed lengths 512..1100 in the same pool, and the selective scan
    of a Jamba prefill (16 prompts padded to 1024, d_inner 8192, d_state
    16, x bf16, dt fp32; "ssm_scan[b1]": one 1024-token prompt). The
    quantized paged kernels take the same shapes
    on the pool's rows quantized to int8 and to fp8 (``quant``: kv_dtype ->
    (k, v, k_scale, v_scale))."""
    dt, hq, hkv, d = torch.bfloat16, 64, 8, 128
    out = _paged_timing_inputs(dev, gen, hq, hkv, d)
    kp, vp, tbl = (out["paged_decode_attention"][n] for n in
                   ("kp", "vp", "tbl"))
    out["decode_attention"] = dict(
        q=_rand(gen, (16, 1, hq, d), dt, dev),
        k=_rand(gen, (16, 2048, hkv, d), dt, dev),
        v=_rand(gen, (16, 2048, hkv, d), dt, dev),
        kv_len=torch.randint(512, 1101, (16,), generator=gen, device=dev))
    kv_start = torch.randint(512, 1101, (16,), generator=gen, device=dev)
    out["paged_verify_attention"] = dict(
        q=_rand(gen, (16, 5, hq, d), dt, dev), kp=kp, vp=vp, tbl=tbl,
        kv_start=kv_start, kv_len=kv_start + 5)
    # the zoo's serves: granite-20b (g 48) and granite-moe-3b (g 3), and
    # verify at their widths on their decode pools (phase 3's 16 slots of
    # k + 1 = 5 candidates at committed lengths 512..1100)
    for tag, widths in zip(("g48", "g3"), ZOO_WIDTHS):
        for name, x in _paged_timing_inputs(dev, gen, **widths).items():
            out[f"{name}[{tag}]"] = x
        z = out[f"paged_decode_attention[{tag}]"]
        ks = torch.randint(512, 1101, (16,), generator=gen, device=dev)
        out[f"paged_verify_attention[{tag}]"] = dict(
            q=_rand(gen, (16, 5, widths["hq"], widths["d"]), dt, dev),
            kp=z["kp"], vp=z["vp"], tbl=z["tbl"], kv_start=ks,
            kv_len=ks + 5)
    out["ssm_scan"] = _scan_inputs(gen, dev, 16, 1024, 8192, 16, dt)
    # and a lone 1024-token prompt: 1 / 16 of the work on as many SMs
    out["ssm_scan[b1]"] = _scan_inputs(gen, dev, 1, 1024, 8192, 16, dt)
    # h2o-danube-1.8b's long-prompt serve (phase 6; d 80, g 4): a static
    # batch of 4 prompts of 4600..4604 tokens left-padded to 4604 under its
    # 4096-token window, and a decode step on its full 4096-slot ring
    hq, hkv, d, s = 32, 8, 80, 4604
    out["flash_attention[d80]"] = dict(
        q=_rand(gen, (4, s, hq, d), dt, dev),
        k=_rand(gen, (4, s, hkv, d), dt, dev),
        v=_rand(gen, (4, s, hkv, d), dt, dev),
        kv_start=torch.tensor([0, 1, 2, 4], device=dev), window=4096)
    out["decode_attention[d80]"] = dict(
        q=_rand(gen, (4, 1, hq, d), dt, dev),
        k=_rand(gen, (4, 4096, hkv, d), dt, dev),
        v=_rand(gen, (4, 4096, hkv, d), dt, dev))
    return out


def _paged_timing_inputs(dev, gen, hq, hkv, d):
    """Phase 3's prefill, paged decode and paged context inputs at widths
    (hq, hkv, d), bf16: flash on 16 prompts padded to 1024, decode on 16
    slots of 512..1040 keys in a 2049-block pool of 16, the context on 4
    rows of 256 tokens at 256-token offsets; "quant": the pool's rows
    quantized to int8 and to fp8, kv_dtype -> (k, v, k_scale, v_scale)."""
    from repro_torch.models import quant
    dt, bs, b, s = torch.bfloat16, 16, 16, 1024
    out = {"flash_attention": dict(
        q=_rand(gen, (b, s, hq, d), dt, dev),
        k=_rand(gen, (b, s, hkv, d), dt, dev),
        v=_rand(gen, (b, s, hkv, d), dt, dev))}
    n_blocks, nb = 16 * 128 + 1, 128
    kp, vp, _ = _pool(gen, dev, dt, n_blocks, bs, hkv, d)
    out["quant"] = {}
    for kv in ("int8", "fp8"):
        (kq, ks), (vq, vs) = (quant.quantize_kv_rows(t, kv) for t in (kp, vp))
        out["quant"][kv] = (kq, vq, ks, vs)
    tbl = (torch.randperm(n_blocks - 1, generator=gen, device=dev)
           + 1).reshape(16, nb).to(torch.int32)
    kv_len = torch.randint(512, 1041, (16,), generator=gen, device=dev)
    out["paged_decode_attention"] = dict(
        q=_rand(gen, (16, 1, hq, d), dt, dev), kp=kp, vp=vp, tbl=tbl,
        kv_len=kv_len)
    q_start = torch.tensor([0, 256, 512, 768], device=dev)
    out["paged_context_attention"] = dict(
        q=_rand(gen, (4, 256, hq, d), dt, dev), kp=kp, vp=vp, tbl=tbl[:4],
        q_start=q_start, kv_len=q_start + 256)
    return out


def _flash_timing(x, flush):
    """#1 on a causal joint prefill x: its call, bytes, operations (the
    causal pairs) and SDPA's time."""
    from repro_torch.kernels import ops
    q, k, v = x["q"], x["k"], x["v"]
    b, s, hq, d = q.shape
    pairs = b * s * (s + 1) // 2                       # causal
    return dict(fn=lambda: ops.flash_attention(q, k, v),
                nbytes=q.element_size() * (2 * q.numel() + k.numel()
                                           + v.numel()),
                flops=4 * d * hq * pairs,
                library_ms=_time_sdpa(q, k, v, flush, is_causal=True))


def _rate(q):
    """The peak rate of the body q's dtype runs on: the fp32 bodies are
    scalar, the bf16 ones use the tensor cores; and the dtype whose
    tolerance a check of it takes."""
    return dict(flop_rate=(FP32_FLOP_PER_S if q.dtype == torch.float32
                           else BF16_FLOP_PER_S), dtype=q.dtype)


def _paged_decode_timing(x, quant=None):
    """#2 on the decode inputs x, or #5 with `quant` = (k, v, k_scale,
    v_scale), the pool's rows quantized: a key costs 2 d kes bytes per kv
    head (kes: the pool's element size, q's or the other width's), or
    2 d + 8 on a quantized pool (two one-byte rows, two fp32 scales)."""
    from repro_torch.kernels import ops
    q, tbl, kv_len = x["q"], x["tbl"], x["kv_len"]
    _, _, hq, d = q.shape
    hkv = x["kp"].shape[2]
    es, kv = q.element_size(), int(kv_len.sum())
    kes = x["kp"].element_size()
    if quant is None:
        return dict(fn=lambda: ops.paged_decode_attention(
            q, x["kp"], x["vp"], tbl, kv_len=kv_len),
            nbytes=es * 2 * q.numel() + kes * 2 * kv * hkv * d
            + 4 * (tbl.numel() + 16),
            flops=4 * d * hq * kv, library_ms=None, **_rate(q))
    kq, vq, ks, vs = quant
    return dict(fn=lambda: ops.paged_decode_attention(
        q, kq, vq, tbl, kv_len=kv_len, k_scale=ks, v_scale=vs),
        nbytes=es * 2 * q.numel() + kv * hkv * (2 * d + 8)
        + 4 * (tbl.numel() + 16),
        flops=4 * d * hq * kv, library_ms=None)


def _paged_context_timing(y, quant=None):
    """#3 on the context inputs y, or #6 on the quantized pool `quant`;
    the operations count each query's causal keys."""
    from repro_torch.kernels import ops
    q, tbl = y["q"], y["tbl"]
    _, C, hq, d = q.shape
    hkv = y["kp"].shape[2]
    es, kes = q.element_size(), y["kp"].element_size()
    starts, lens = y["q_start"].tolist(), y["kv_len"].tolist()
    pairs = sum(sum(min(st + j + 1, ln) for j in range(C))
                for st, ln in zip(starts, lens))
    if quant is None:
        return dict(fn=lambda: ops.paged_context_attention(
            q, y["kp"], y["vp"], tbl, q_start=y["q_start"],
            kv_len=y["kv_len"]),
            nbytes=es * 2 * q.numel() + kes * 2 * sum(lens) * hkv * d
            + 4 * (tbl.numel() + 8),
            flops=4 * d * hq * pairs, library_ms=None, **_rate(q))
    kq, vq, ks, vs = quant
    return dict(fn=lambda: ops.paged_context_attention(
        q, kq, vq, tbl, q_start=y["q_start"], kv_len=y["kv_len"],
        k_scale=ks, v_scale=vs),
        nbytes=es * 2 * q.numel() + sum(lens) * hkv * (2 * d + 8)
        + 4 * (tbl.numel() + 8),
        flops=4 * d * hq * pairs, library_ms=None)


def _paged_verify_timing(w, quant=None):
    """#4 on the verify inputs w, or #7 on the quantized pool `quant`; the
    operations count each candidate's causal keys."""
    from repro_torch.kernels import ops
    q, tbl = w["q"], w["tbl"]
    _, T, hq, d = q.shape
    hkv = w["kp"].shape[2]
    es, kes = q.element_size(), w["kp"].element_size()
    starts, lens = w["kv_start"].tolist(), w["kv_len"].tolist()
    pairs = sum(sum(min(st + j + 1, ln) for j in range(T))
                for st, ln in zip(starts, lens))
    if quant is None:
        return dict(fn=lambda: ops.paged_verify_attention(
            q, w["kp"], w["vp"], tbl, kv_start=w["kv_start"],
            kv_len=w["kv_len"]),
            nbytes=es * 2 * q.numel() + kes * 2 * sum(lens) * hkv * d
            + 4 * (tbl.numel() + 32),
            flops=4 * d * hq * pairs, library_ms=None, **_rate(q))
    kq, vq, ks, vs = quant
    return dict(fn=lambda: ops.paged_verify_attention(
        q, kq, vq, tbl, kv_start=w["kv_start"], kv_len=w["kv_len"],
        k_scale=ks, v_scale=vs),
        nbytes=es * 2 * q.numel() + sum(lens) * hkv * (2 * d + 8)
        + 4 * (tbl.numel() + 32),
        flops=4 * d * hq * pairs, library_ms=None)


def _sdpa_inputs(q, k, v):
    """q, k, v (b, s, h, d) in F.scaled_dot_product_attention's (b, h, s,
    d) layout, and its GQA keywords: enable_gqa from torch 2.5 on, before
    that the kv heads shared by copy."""
    hq, hkv = q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return qt, kt, vt, dict(enable_gqa=True)
    kt, vt = (t.repeat_interleave(hq // hkv, dim=1) for t in (kt, vt))
    return qt, kt, vt, {}


def _time_sdpa(q, k, v, flush, **kw):
    """Device ms of F.scaled_dot_product_attention on the same inputs in
    its (b, h, s, d) layout (the transposes are not timed): the library
    yardstick, never called by the port."""
    qt, kt, vt, gqa = _sdpa_inputs(q, k, v)
    return _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **gqa, **kw), flush)


def time_kernels(dev):
    """{kernel: dict(ms, plain_ms, bound_ms, bound_by, library_ms,
    max_abs_err)} at the serving path's shapes, bf16 (the scan's state and
    dt fp32)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(1)
    inp = timing_inputs(dev, gen)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    res = {}

    q = inp["flash_attention"]["q"]
    _, _, hq, d = q.shape
    hkv = inp["flash_attention"]["k"].shape[2]
    es = q.element_size()
    res["flash_attention"] = _flash_timing(inp["flash_attention"], flush)
    x = inp["paged_decode_attention"]
    res["paged_decode_attention"] = _paged_decode_timing(x)
    y = inp["paged_context_attention"]
    res["paged_context_attention"] = _paged_context_timing(y)

    z = inp["decode_attention"]
    kv = int(z["kv_len"].sum())
    mask = (torch.arange(z["k"].shape[1], device=dev)[None]
            < z["kv_len"][:, None])[:, None, None]          # (b, 1, 1, S)
    res["decode_attention"] = dict(
        fn=lambda: ops.decode_attention(z["q"], z["k"], z["v"],
                                        kv_len=z["kv_len"]),
        nbytes=es * (2 * z["q"].numel() + 2 * kv * hkv * d) + 4 * 16,
        flops=4 * d * hq * kv,
        library_ms=_time_sdpa(z["q"], z["k"], z["v"], flush, attn_mask=mask))

    # h2o-danube-1.8b's (d 80): the keys each query really sees under the
    # window and the left padding count; the library call takes the same
    # mask as a boolean tensor
    f = inp["flash_attention[d80]"]
    b, s, hq80, d80 = f["q"].shape
    W, starts80 = f["window"], f["kv_start"].tolist()
    pairs = sum(p - max(ks, p - W + 1) + 1 for ks in starts80
                for p in range(ks, s))
    pos = torch.arange(s, device=dev)
    mask = ((pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
            )[None] & (pos[None, None, :] >= f["kv_start"][:, None, None])
    res["flash_attention[d80]"] = dict(
        fn=lambda: ops.flash_attention(f["q"], f["k"], f["v"], window=W,
                                       kv_start=f["kv_start"]),
        nbytes=es * (2 * f["q"].numel() + f["k"].numel() + f["v"].numel()),
        flops=4 * d80 * hq80 * pairs,
        library_ms=_time_sdpa(f["q"], f["k"], f["v"], flush,
                              attn_mask=mask[:, None]))
    del mask
    r80 = inp["decode_attention[d80]"]
    res["decode_attention[d80]"] = dict(
        fn=lambda: ops.decode_attention(r80["q"], r80["k"], r80["v"]),
        nbytes=es * (2 * r80["q"].numel() + r80["k"].numel()
                     + r80["v"].numel()),
        flops=4 * d80 * hq80 * r80["k"].shape[0] * r80["k"].shape[1],
        library_ms=_time_sdpa(r80["q"], r80["k"], r80["v"], flush))

    w = inp["paged_verify_attention"]
    res["paged_verify_attention"] = _paged_verify_timing(w)

    # K2: #2, #3 and #4 at the same shapes on the pool of the other width:
    # fp32 q on the bf16 pool ("bf16-pool"), bf16 q on it widened to fp32
    # ("fp32-pool", bf16 values as a bf16 model writes them)
    for qdt, tag in MIXED_TAGS.items():
        pdt = torch.bfloat16 if qdt == torch.float32 else torch.float32
        pools = dict(kp=x["kp"].to(pdt), vp=x["vp"].to(pdt))
        res[f"paged_decode_attention[{tag}]"] = _paged_decode_timing(
            dict(x, q=x["q"].to(qdt), **pools))
        res[f"paged_context_attention[{tag}]"] = _paged_context_timing(
            dict(y, q=y["q"].to(qdt), **pools))
        res[f"paged_verify_attention[{tag}]"] = _paged_verify_timing(
            dict(w, q=w["q"].to(qdt), **pools))

    # the quantized kernels at the same shapes: the same calls with the
    # pools' one-byte payloads and scales; a key costs 2 d + 8 bytes per kv
    # head (K and V rows, two fp32 scales) instead of 2 d es
    for kv, (kq, vq, ks, vs) in inp["quant"].items():
        tag = "" if kv == "int8" else f"[{kv}]"
        res["paged_decode_attention_quant" + tag] = _paged_decode_timing(
            x, (kq, vq, ks, vs))
        res["paged_context_attention_quant" + tag] = _paged_context_timing(
            y, (kq, vq, ks, vs))
        res["paged_verify_attention_quant" + tag] = _paged_verify_timing(
            w, (kq, vq, ks, vs))

    # the zoo's serve shapes: #1, #2 and #3 at granite-20b's g 48, #1, #2
    # and #5 (int8 pools) at granite-moe-3b's g 3
    res["flash_attention[g48]"] = _flash_timing(
        inp["flash_attention[g48]"], flush)
    res["paged_decode_attention[g48]"] = _paged_decode_timing(
        inp["paged_decode_attention[g48]"])
    res["paged_context_attention[g48]"] = _paged_context_timing(
        inp["paged_context_attention[g48]"])
    res["flash_attention[g3]"] = _flash_timing(inp["flash_attention[g3]"],
                                               flush)
    res["paged_decode_attention[g3]"] = _paged_decode_timing(
        inp["paged_decode_attention[g3]"])
    res["paged_decode_attention_quant[g3]"] = _paged_decode_timing(
        inp["paged_decode_attention[g3]"], inp["quant[g3]"]["int8"])
    # and the zoo rows phase 7 launches but did not time: #4 at g 48
    # (granite-20b's n-gram serve), #6 at g 3 (granite-moe's int8 pages),
    # and #7 on int8 pools at both widths (no zoo serve launches it)
    res["paged_verify_attention[g48]"] = _paged_verify_timing(
        inp["paged_verify_attention[g48]"])
    res["paged_context_attention_quant[g3]"] = _paged_context_timing(
        inp["paged_context_attention[g3]"], inp["quant[g3]"]["int8"])
    for tag in ("g48", "g3"):
        res[f"paged_verify_attention_quant[{tag}]"] = _paged_verify_timing(
            inp[f"paged_verify_attention[{tag}]"],
            inp[f"quant[{tag}]"]["int8"])

    # the scan: x, dt, B, C, A, D read once, y and the fp32 state written
    # once; per (row, step, channel) ds exponentials and ~6 ds + 3 fp32
    # operations (the exponent's product, the state update's product and
    # FMA, C's FMA; dt x, D x and the sum)
    for name in ("ssm_scan", "ssm_scan[b1]"):
        g = inp[name]
        b, s, din = g["x"].shape
        ds = g["A"].shape[1]
        res[name] = dict(
            fn=lambda g=g: ops.ssm_scan(g["x"], g["dt"], g["A"], g["B"],
                                        g["C"], g["D"]),
            nbytes=sum(t.numel() * t.element_size()
                       for k, t in g.items() if t is not None)
            + g["x"].numel() * g["x"].element_size() + b * din * ds * 4,
            flops=b * s * din * (6 * ds + 3), flop_rate=FP32_FLOP_PER_S,
            exps=b * s * din * ds, library_ms=None)

    out = {}
    for name, r in res.items():
        torch.cuda.empty_cache()      # the plain d-80 prefill takes ~50 GB
        got, want = _run_both(r["fn"])
        err = _compare_out(name, "serving shape", got, want,
                           r.get("dtype", torch.bfloat16))
        del got, want
        ms = _time_ms(r["fn"], flush)
        with ops.backend("plain"):
            plain_ms = _time_ms(r["fn"], flush, iters=3)
        bound_ms, bound_by = _bound(
            r["nbytes"], r["flops"],
            flop_rate=r.get("flop_rate", BF16_FLOP_PER_S),
            exps=r.get("exps", 0))
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=r["library_ms"],
                         max_abs_err=err)
        lib_s = ("" if r["library_ms"] is None
                 else f" library {r['library_ms']:.3f} ms")
        log(f"  time {name}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}){lib_s}, "
            f"{'fp32' if r.get('dtype') == torch.float32 else 'bf16'} max "
            f"abs err {err:.3g}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3: serving at full Llama-2-70B width (bf16, depth cut to 4 layers)
# ---------------------------------------------------------------------------

# llama2-70b's depth in phases 3, 5 and 6: 4 of 80 layers (cut from 8 so
# that phase 6's full-depth h2o-danube serves fit the script's time)
SERVE_LAYERS = 4


def _pipeline_asg(L):
    """The two-stage pipeline of an L-layer model (phases 3, 4 and 7): 3/8
    of the layers, at least one, on a TP-2 stage, the rest on one device
    ([3, 5] at 8 layers)."""
    from repro_torch.core.plan import Assignment, PipelinePlan, StagePlan
    lo = max(1, L * 3 // 8)
    return Assignment([PipelinePlan([StagePlan([0, 1], lo),
                                     StagePlan([2], L - lo)])])


def _llama(num_layers):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama2-70b"),
                               num_layers=num_layers)


def _serve(cfg, asg, params, reqs, around=contextlib.nullcontext,
           cache_layout="paged", controller=None, **kw):
    """Serve reqs on a fresh engine (paged unless `cache_layout` says
    otherwise; an online-rescheduling `controller` attached to its
    Router), inside the context `around()` (the engine is built outside
    it); check every request got its tokens.
    Returns (stats, wall seconds, dict(draft_steps: draft decode steps
    run, kvsan_violations: what KVSAN recorded on the replicas,
    weight_bytes: bytes of the replica's weights on the card,
    state_bytes: bytes of its Mamba layers' per-slot state))."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.loop import VirtualClock
    eng = InferenceEngine(cfg, asg, params=params, device=DEVICE,
                          cache_layout=cache_layout, **kw)
    if controller is not None:
        eng.router.attach_controller(controller)
    torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        stats = eng.serve(reqs, deadline=1e9, clock=VirtualClock())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r in reqs:
        if r.output is None or len(r.output) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid}: got "
                                 f"{None if r.output is None else len(r.output)}"
                                 f" of {r.max_new_tokens} tokens")
        if not ((0 <= r.output) & (r.output < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.rid}: token out of vocab")
    if stats.rejected or stats.dropped:
        raise AssertionError(stats.summary())
    info = dict(draft_steps=sum(
        getattr(getattr(w, "_proposer", None), "draft_steps", 0)
        for w in eng.router.workers), kvsan_violations=sum(
        len(w._san.violations) for w in eng.router.workers
        if getattr(w, "_san", None) is not None))
    weights = {}        # stages share the head's tensors: count each once
    for st in eng.replicas[0].stages:
        for t in _leaves({"layers": dict(enumerate(st.layer_params)),
                          "head": st.head_params or {}}):
            weights[t.data_ptr()] = t.numel() * t.element_size()
    info["weight_bytes"] = sum(weights.values())
    info["state_bytes"] = sum(        # Mamba layers' per-slot state
        t.numel() * t.element_size()
        for caches in eng.replicas[0].paged_caches or () for c in caches
        if "k" not in c for t in c.values())
    del eng
    return stats, wall, info


def _workloads(vocab, n, out_len, prompt_len=512, shared_len=1024):
    from repro_torch.serving.request import (shared_prefix_workload,
                                             synth_workload)
    synth = synth_workload(rate=8.0, duration=8.0, vocab=vocab,
                           prompt_len=prompt_len, prompt_jitter=prompt_len,
                           out_len=out_len, seed=0)[:n]
    # arrivals spread out (one per two iterations of the virtual clock)
    # so that later prompts find the shared prefix the first one indexed;
    # a burst would prefill every copy cold, chunk by chunk, in parallel
    shared = shared_prefix_workload(rate=0.5, duration=64.0, vocab=vocab,
                                    shared_len=shared_len, unique_len=64,
                                    out_len=out_len, seed=0)[:n]
    return synth, shared


PAGED = ("paged_decode_attention", "paged_context_attention",
         "paged_verify_attention")


def _check_path(name, stats, launched, draft_steps, reqs, L, n_slots, kw):
    """Raise unless the path `name`, served with engine kwargs `kw`, ran its
    kernels: at least L launches per step of each kernel it drives. On
    quantized pools (``kv_dtype``) a paged step launches the quantized
    kernel on the L - G quantized layers and the unquantized one on the G
    guard layers only, so the two counts must stand in that ratio; without
    ``kv_dtype`` no quantized kernel may run."""
    need = {}
    max_new = max(r.max_new_tokens for r in reqs)
    out_tok = sum(len(r.output) for r in reqs)
    # an unquantized pool of the other width runs the unquantized kernels
    kv = kw.get("kv_dtype") if kw.get("kv_dtype") in ("int8", "fp8") \
        else None
    G = len(kw.get("kv_guard_layers", ()))

    def paged(kernel, steps):
        if kv is None:
            need[kernel] = L * steps
            return
        need[kernel + "_quant"] = (L - G) * steps
        if G:
            need[kernel] = G * steps

    if kw.get("prefix_caching"):
        # the first prompt's chunks, then decode
        paged("paged_context_attention", -(-len(reqs[0].prompt) // 256))
        paged("paged_decode_attention", max_new)
        if stats.prefix_hits == 0:
            raise AssertionError(f"{name}: no prefix hit; {stats.summary()}")
    elif kw.get("spec_decode"):
        # one verify dispatch serves every slot's chunk
        paged("paged_verify_attention",
              max(1, -(-stats.spec_steps // n_slots)))
        if stats.spec_tokens != out_tok:
            raise AssertionError(f"{name}: spec_tokens {stats.spec_tokens} "
                                 f"!= {out_tok} generated")
    else:
        need["flash_attention"] = L                 # >= 1 joint prefill
        paged("paged_decode_attention", max_new)
    if kw.get("draft_model") is not None:
        need["decode_attention"] = max(1, L * draft_steps)
        if stats.spec_steps >= out_tok:
            raise AssertionError(f"{name}: {stats.spec_steps} target steps "
                                 f"for {out_tok} tokens: the self-draft had "
                                 "no proposal accepted")
    for k, n in need.items():
        if launched[k] < n:
            raise AssertionError(f"{name}: {k} ran {launched[k]} < {n} "
                                 "times")
    for k in PAGED:
        plain, quant = launched[k], launched[k + "_quant"]
        if quant if kv is None else plain * (L - G) != quant * G:
            raise AssertionError(
                f"{name}: {k} ran {plain} times and its quantized kernel "
                f"{quant} times on {L - G} quantized of {L} layers")


def study_rewritten_kernels(cfg, asg, params, serves):
    """The redesigned paged kernels on the serves' own inputs: the
    synthetic serve's paged decode calls (#2), the shared-prefix serve's
    context calls (#3), the n-gram serve's verify calls (#4), the
    quant-int8 serve's quantized context (#6) and decode (#5) calls and the
    quant-fp8-ngram serve's quantized verify calls (#7) are sampled (their
    inputs copied at the call), and on each sample the kernel and the plain
    version's own rounding to bf16 (the floor) are held against the plain
    version in fp32."""
    from repro_torch.kernels import ops
    for name, serve, every, quant in (
            ("paged_decode_attention", "synthetic", 67, False),
            ("paged_context_attention", "shared-prefix", 23, False),
            ("paged_verify_attention", "spec-ngram", 37, False),
            ("paged_context_attention", "quant-int8", 23, True),
            ("paged_decode_attention", "quant-int8", 67, True),
            ("paged_verify_attention", "quant-fp8-ngram", 37, True)):
        real, calls, samples = getattr(ops, name), [0], []

        def sampling(*a, **k):
            if ("k_scale" in k) == quant:
                if calls[0] % every == 0 and len(samples) < 4:
                    samples.append(([t.clone() for t in a], {
                        x: t.clone() if torch.is_tensor(t) else t
                        for x, t in k.items()}))
                calls[0] += 1
            return real(*a, **k)

        kw = dict(serves)[serve]
        synth, shared = _workloads(cfg.vocab_size, n=16, out_len=32)
        setattr(ops, name, sampling)
        try:
            _serve(cfg, asg, params, shared if kw.get("prefix_caching")
                   else synth, n_slots=16, max_len=2048, block_size=16, **kw)
        finally:
            setattr(ops, name, real)
        err = {}
        for a, k in samples:
            q, kp, vp, tbl = a
            with ops.backend("plain"):     # fp32: the plain versions widen
                want = real(q.float(), kp, vp, tbl, **k)
            for key, out in (("kernel", real(*a, **k)),
                             ("plain (bf16 floor)", want.to(q.dtype))):
                d = (out.float() - want).abs()
                err.setdefault(key, []).append((float(d.max()),
                                                float(d.mean())))
            del want
        log(f"  {name}{' (quantized)' if quant else ''} on the {serve} "
            f"serve's inputs ({len(samples)} of {calls[0]} calls, q "
            f"{tuple(samples[0][0][0].shape)}, pool "
            f"{tuple(samples[0][0][1].shape)}) against the fp32 plain "
            "version: " + "; ".join(
                f"{key} max abs err {max(m for m, _ in e):.4g}, mean "
                f"{np.mean([x for _, x in e]):.4g}" for key, e in err.items()))
        del samples
        torch.cuda.empty_cache()


def phase_serving(smi):
    """Full-width bf16 serving through the asymmetric 2-stage pipeline on
    the card. Returns the launch counts summed over the measured serves,
    each serve's counts zeroed just before it and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = _llama(SERVE_LAYERS)
    L = cfg.num_layers
    asg = _pipeline_asg(L)
    params = M.init_params(cfg, 0, device=DEVICE)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 3: {cfg.name} at full width, {L} of 80 layers, "
        f"{n_params / 1e9:.2f}e9 params {cfg.dtype} "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), stages "
        f"{asg.pipelines[0].layer_split}")
    common = dict(n_slots=16, max_len=2048, block_size=16)
    spec = dict(spec_decode=True, spec_k=4)
    # warm-up: cuBLAS handles, kernel loading and allocator growth happen
    # once per process and would otherwise land in the first measured serve
    for kw in ({}, spec):
        _serve(cfg, asg, params,
               _workloads(cfg.vocab_size, n=4, out_len=4)[0], **common, **kw)
    mark("phase 3 warm-up")
    counts = dict.fromkeys(ops.KERNELS, 0)
    prefix = dict(prefix_caching=True, prefill_chunk=256)
    # the self-draft (draft_seed 0, like the target's weights) is a second
    # copy of the model with a 16 x 2048 contiguous cache; the
    # quantized serves keep the first and last layers' pools at bf16
    serves = (("synthetic", {}), ("shared-prefix", prefix),
              ("spec-ngram", spec), ("spec-draft", dict(spec, draft_model=cfg)),
              ("quant-int8", dict(prefix, kv_dtype="int8",
                                  kv_guard_layers=(0, L - 1))),
              ("quant-fp8-ngram", dict(spec, kv_dtype="fp8")),
              ("quant-w8", dict(quantize=True)))
    outputs, peaks = {}, []
    for name, kw in serves:
        synth, shared = _workloads(cfg.vocab_size, n=16, out_len=32)
        base = "shared-prefix" if kw.get("prefix_caching") else "synthetic"
        reqs = shared if base == "shared-prefix" else synth
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        stats, wall, info = _serve(cfg, asg, params, reqs, **common, **kw)
        launched = ops.launch_counts()
        peaks.append(torch.cuda.max_memory_allocated())
        for k in counts:
            counts[k] += launched[k]
        outputs[name] = [list(r.output) for r in reqs]
        out_tok = sum(len(r.output) for r in reqs)
        in_tok = sum(len(r.prompt) for r in reqs)
        acc = (f"; accept rate {stats.spec_accepted / stats.spec_proposed:.3f}"
               f" ({stats.spec_accepted}/{stats.spec_proposed}), "
               f"{out_tok / stats.spec_steps:.2f} tokens per slot step, "
               f"{info['draft_steps']} draft steps"
               if stats.spec_proposed else "")
        log(f"  serve {name}: {len(reqs)} requests, {in_tok} prompt + "
            f"{out_tok} generated tokens in {wall:.3f} s wall = "
            f"{out_tok / wall:.1f} generated tok/s, "
            f"{(in_tok + out_tok) / wall:.1f} total tok/s; "
            f"{stats.iterations} iterations; {stats.summary()}{acc}; "
            f"launches {launched}")
        # at full width on random weights near-ties are common, so how
        # many greedy outputs a serve keeps against the plain bf16 serve of
        # its workload is reported, not gated; the bf16 spec serves (the
        # same weights and pools, another attention path) show how far
        # rounding alone moves them
        max_new = max(r.max_new_tokens for r in reqs)
        same = sum(a == b for a, b in zip(outputs[name], outputs[base]))
        lead = np.mean([next((j for j, (x, y) in enumerate(zip(a, b))
                              if x != y), len(a))
                        for a, b in zip(outputs[name], outputs[base])])
        log(f"  memory {name}: kv_bytes_resident {stats.kv_bytes_resident} "
            f"({stats.kv_bytes_resident / 2**30:.3f} GiB), kv_bytes_saved "
            f"{stats.kv_bytes_saved} ({stats.kv_bytes_saved / 2**30:.3f} "
            f"GiB), weights {info['weight_bytes'] / 2**30:.2f} GiB, peak "
            f"device memory {peaks[-1] / 2**30:.2f} GiB; "
            + (f"{same}/{len(reqs)} requests' greedy outputs equal the bf16 "
               f"{base} serve's, the first {lead:.2f} of {max_new} tokens "
               "agree on average" if name != base else ""))
        _check_path(name, stats, launched, info["draft_steps"], reqs, L,
                    common["n_slots"], kw)
    log(f"  peak device memory {max(peaks) / 2**30:.2f} GiB over the serves "
        f"(torch.cuda.max_memory_allocated) on {smi}")
    mark("phase 3 serves")
    study_rewritten_kernels(cfg, asg, params, serves)
    mark("phase 3 sampled calls")
    for name, kw in serves:
        if name in ("synthetic", "shared-prefix", "spec-draft", "quant-int8",
                    "quant-fp8-ngram", "quant-w8"):
            synth, shared = _workloads(cfg.vocab_size, n=16, out_len=32)
            reqs = shared if kw.get("prefix_caching") else synth
            profile_serve(name, cfg, asg, params, reqs, **common, **kw)
    del params
    torch.cuda.empty_cache()
    return counts


def _jamba(periods, dtype=None):
    """jamba-v0.1-52b at its published widths, depth cut to `periods`
    8-layer periods."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("jamba-v0.1-52b")
    return dataclasses.replace(cfg, num_layers=8 * periods,
                               dtype=dtype or cfg.dtype)


@contextlib.contextmanager
def _pipeline_calls():
    """Counts AsymmetricPipeline's joint prefills and decode iterations
    while the block runs."""
    from repro_torch.serving.pipeline import AsymmetricPipeline as AP
    calls = dict.fromkeys(("insert_slots_paged", "decode_slots_paged"), 0)
    saved = {n: getattr(AP, n) for n in calls}

    def counted(n):
        def call(self, *a, **kw):
            calls[n] += 1
            return saved[n](self, *a, **kw)
        return call
    for n in calls:
        setattr(AP, n, counted(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(AP, n, fn)


def _jamba_asg():
    from repro_torch.core.plan import Assignment, PipelinePlan, StagePlan
    # stage 0: layers 0-2, all Mamba; stage 1: layers 3-7, the attention
    # layer 4 among them
    return Assignment([PipelinePlan([StagePlan([0, 1], 3),
                                     StagePlan([2], 5)])])


@contextlib.contextmanager
def _scan_shapes():
    """Records the (b, s) of each selective-scan launch while the block
    runs."""
    from repro_torch.kernels import ops
    shapes, launch = [], ops.ssm_scan_cuda

    def logged(x, *a, **kw):
        shapes.append(tuple(x.shape[:2]))
        return launch(x, *a, **kw)
    ops.ssm_scan_cuda = logged
    try:
        yield shapes
    finally:
        ops.ssm_scan_cuda = launch


def phase_jamba(smi):
    """Full-width bf16 hybrid serving: jamba-v0.1-52b, one period, through
    the [3, 5] pipeline. Returns the launch counts of the measured serve,
    zeroed just before it and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = _jamba(1)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attn")
    asg = _jamba_asg()
    params = M.init_params(cfg, 0, device=DEVICE)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 3 (hybrid): {cfg.name} at full width, {cfg.num_layers} of "
        f"32 layers ({n_mamba} Mamba, {n_attn} attention, MoE on "
        f"{sum(map(cfg.is_moe_layer, range(cfg.num_layers)))}), "
        f"{n_params / 1e9:.2f}e9 params {cfg.dtype} "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), stages "
        f"{asg.pipelines[0].layer_split}")
    common = dict(n_slots=16, max_len=2048, block_size=16)
    _serve(cfg, asg, params, _workloads(cfg.vocab_size, n=4, out_len=4)[0],
           **common)                                      # warm-up
    reqs = _workloads(cfg.vocab_size, n=16, out_len=32)[0]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _pipeline_calls() as calls, _scan_shapes() as scans:
        stats, wall, info = _serve(cfg, asg, params, reqs, **common)
    launched = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    out_tok = sum(len(r.output) for r in reqs)
    in_tok = sum(len(r.prompt) for r in reqs)
    prefills, steps = calls["insert_slots_paged"], calls["decode_slots_paged"]
    log(f"  serve jamba synthetic: {len(reqs)} requests, {in_tok} prompt + "
        f"{out_tok} generated tokens in {wall:.3f} s wall = "
        f"{out_tok / wall:.1f} generated tok/s, "
        f"{(in_tok + out_tok) / wall:.1f} total tok/s; {prefills} joint "
        f"prefills, {steps} decode iterations, {stats.iterations} "
        f"iterations; {stats.summary()}; launches {launched}")
    log(f"  memory jamba synthetic: weights {info['weight_bytes']} bytes "
        f"({info['weight_bytes'] / 2**30:.2f} GiB), Mamba slot state "
        f"{info['state_bytes']} bytes ({info['state_bytes'] / 2**20:.1f} "
        f"MiB), page pools (kv_bytes_resident) {stats.kv_bytes_resident} "
        f"bytes ({stats.kv_bytes_resident / 2**20:.1f} MiB), peak device "
        f"memory {peak / 2**30:.2f} GiB on {smi}")
    log("  scan launches jamba synthetic (b, s): " + ", ".join(
        f"{shape} x{n}" for shape, n in
        sorted(collections.Counter(scans).items())))
    need = {"ssm_scan": n_mamba * prefills,
            "flash_attention": n_attn * prefills,
            "paged_decode_attention": n_attn * steps}
    if not prefills or not steps:
        raise AssertionError(f"jamba: {prefills} prefills, {steps} decode "
                             "iterations")
    for k, n in need.items():
        if launched[k] < n:
            raise AssertionError(f"jamba: {k} ran {launched[k]} < {n} times")
    profile_serve("jamba synthetic", cfg, asg, params,
                  _workloads(cfg.vocab_size, n=16, out_len=32)[0], **common)
    del params
    torch.cuda.empty_cache()
    return launched


def _kernel_group(name):
    if name.startswith(("void rt::attn_fwd", "void fa::flash_fwd",
                        "void dk::decode_fwd", "void pc::context_fwd")):
        return "attention kernels (port)"
    if name.startswith("void ss::ssm_scan_kernel"):
        return "scan (port)"
    if name.startswith(("void fb::", "void fbh::", "void sb::")):
        return "backward kernels (port)"
    if any(t in name.lower() for t in ("gemm", "cutlass", "sm90_xmma",
                                       "nvjet", "gemv")):
        return "matmul (cuBLAS)"       # MoE expert einsums (bmm) included
    if name.startswith("Memcpy"):
        return "host <-> device copies (Memcpy)"
    if "copy" in name:
        return "copies / casts"
    if "elementwise" in name or "vectorized" in name or "reduce" in name:
        return "elementwise / reductions"
    if "index" in name.lower() or "scatter" in name or "gather" in name:
        return "indexing (page writes, embeddings)"
    return "other"


def profile_serve(name, cfg, asg, params, reqs, **kw):
    """One more serve of path `name` under torch.profiler: device time by
    kernel group, and the share of the wall time the card was busy. The
    profiler's own overhead inflates the wall time of this run; its
    numbers are a breakdown, not the headline."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, wall, _ = _serve(cfg, asg, params, reqs, around=lambda: prof, **kw)
    _log_profile(name, prof, wall)


def _log_profile(name, prof, wall):
    """Log a profiled run's device ms by kernel group and the share of its
    wall `wall` (s) the card was busy."""
    groups, other = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            g = _kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + t / 1e3        # us -> ms
            if g == "other":
                other[e.key] = t / 1e3
    busy = sum(groups.values())
    log(f"  profile {name} (torch.profiler on): wall {wall * 1e3:.1f} ms,"
        f" device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of "
        "wall); device ms by group: "
        + ", ".join(f"{g} {t:.1f}" for g, t in
                    sorted(groups.items(), key=lambda x: -x[1]))
        + "; largest in other: " + "; ".join(
            f"{k[:60]} {t:.1f}" for k, t in
            sorted(other.items(), key=lambda x: -x[1])[:2]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 4: engine parity, kernels against plain versions, fp32
# ---------------------------------------------------------------------------

def _logit_margin(cfg, params, tokens):
    """Top-1 minus top-2 logit after `tokens` (one contiguous prefill
    through the kernels): how near a tie the next greedy choice is."""
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, 1, len(tokens), dtype=torch.float32,
                         device=DEVICE)
    with torch.inference_mode():
        logits, _ = M.prefill(cfg, params,
                              {"tokens": np.asarray(tokens)[None]}, cache)
    top = logits[0].float().topk(2).values
    return float(top[0] - top[1])


def _parted(cfg, params, prompts, got, want, what):
    """Raise at the first token where the streams `got` and `want` part,
    with the greedy top-2 logit margin after `want`'s prefix there."""
    i, j = next((i, j) for i, (a, b) in enumerate(zip(want, got))
                for j, (x, y) in enumerate(zip(a, b)) if x != y)
    margin = _logit_margin(cfg, params, prompts[i] + want[i][:j])
    raise AssertionError(
        f"{what} part for request {i} at token {j} ({got[i][j]} vs "
        f"{want[i][j]}); the greedy top-2 logit margin there is "
        f"{margin:.3g}")


PARITY_FIELDS = ("latencies", "iterations", "prefill_tokens",
                 "prefix_lookups", "prefix_hits", "prefix_hit_tokens",
                 "cow_copies", "preemptions", "spec_steps", "spec_proposed",
                 "spec_accepted", "spec_tokens", "kv_bytes_resident",
                 "kv_bytes_saved")


def phase_parity():
    """The same workloads served through the kernels and through the plain
    versions (fp32, full width, 2 layers): identical greedy tokens and
    ServeStats counters, the page pools' byte counts included. The
    speculative serves (n-gram, and a self-draft: draft_seed 0 draws the
    target's weights) must also give the plain greedy serve's tokens on
    pools of the same precision (tests/test_spec.py's contract). The
    synthetic and shared-prefix workloads run again on int8 and on fp8
    pools, and n-gram speculation on int8 pools: the quantized kernels
    against their plain versions; and the synthetic, shared-prefix and
    n-gram workloads on bf16 pools (K2: #2, #3 and #4 on pools of the
    other width). Returns the bf16-pool serves' kernel-run launches."""
    from repro_torch.core.plan import Assignment, PipelinePlan, StagePlan
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = _llama(2)
    asg = Assignment([PipelinePlan([StagePlan([0], 1), StagePlan([1], 1)])])
    params = M.init_params(cfg, 0, device=DEVICE, dtype=torch.float32)
    common = dict(n_slots=8, max_len=2048, block_size=16,
                  dtype=torch.float32)
    spec = dict(spec_decode=True, spec_k=4)
    prefix = dict(prefix_caching=True, prefill_chunk=256)
    greedy = {}          # kv_dtype -> the plain greedy serve's tokens
    mixed = dict.fromkeys(ops.KERNELS, 0)
    for name, kw in (("synthetic", {}), ("shared-prefix", prefix),
                     ("spec-ngram", spec),
                     ("spec-draft", dict(spec, draft_model=cfg)),
                     ("synthetic int8", dict(kv_dtype="int8")),
                     ("shared-prefix int8", dict(prefix, kv_dtype="int8")),
                     ("synthetic fp8", dict(kv_dtype="fp8")),
                     ("shared-prefix fp8", dict(prefix, kv_dtype="fp8")),
                     ("spec-ngram int8", dict(spec, kv_dtype="int8")),
                     ("synthetic bf16", dict(kv_dtype="bf16")),
                     ("shared-prefix bf16", dict(prefix, kv_dtype="bf16")),
                     ("spec-ngram bf16", dict(spec, kv_dtype="bf16"))):
        outs = []
        for backend in ("kernel", "plain"):
            synth, shared = _workloads(cfg.vocab_size, n=6, out_len=8)
            reqs = shared if kw.get("prefix_caching") else synth
            ops.reset_launch_counts()
            with ops.backend(backend):
                stats, wall, _ = _serve(cfg, asg, params, reqs, **common,
                                        **kw)
            if backend == "kernel" and kw.get("kv_dtype") == "bf16":
                for k, n in ops.launch_counts().items():
                    mixed[k] += n
            outs.append(([list(r.output) for r in reqs], stats, wall))
        (tk, sk, wk), (tp, sp, wp) = outs
        prompts = [list(r.prompt) for r in reqs]
        if tk != tp:
            _parted(cfg, params, prompts, tk, tp,
                    f"{name}: the kernel and plain token streams")
        for f in PARITY_FIELDS:
            if getattr(sk, f) != getattr(sp, f):
                raise AssertionError(f"{name}: ServeStats.{f} differs: "
                                     f"{getattr(sk, f)} vs {getattr(sp, f)}")
        kv = kw.get("kv_dtype")
        if name.startswith("synthetic"):
            greedy[kv] = tk
        elif name.startswith("spec") and tk != greedy[kv]:
            _parted(cfg, params, prompts, tk, greedy[kv],
                    f"{name}: the spec and plain greedy token streams")
        log(f"  parity {name}: {len(tk)} requests x {len(tk[0])} tokens "
            f"identical through kernels ({wk:.3f} s) and plain versions "
            f"({wp:.3f} s)"
            + (", and equal to plain greedy" if name.startswith("spec")
               else "") + f"; {sk.summary()}")
    if not all(mixed[k] for k in PAGED):
        raise AssertionError(f"the bf16-pool serves launched {mixed}")
    del params
    torch.cuda.empty_cache()
    return mixed


def phase_fp32_pool(smi):
    """Phase 4 (K2): llama2-70b at full width in bf16, SERVE_LAYERS layers,
    on fp32 page pools (a bf16 model's --kv-dtype fp32), through the
    kernels: phase 3's synthetic, shared-prefix and n-gram workloads, each
    kernel of a serve's path launched layers x steps times, counted from 0
    just before the serve. Returns their launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = _llama(SERVE_LAYERS)
    L = cfg.num_layers
    asg = _pipeline_asg(L)
    params = M.init_params(cfg, 0, device=DEVICE)
    common = dict(n_slots=16, max_len=2048, block_size=16, kv_dtype="fp32")
    counts = dict.fromkeys(ops.KERNELS, 0)
    _serve(cfg, asg, params, _workloads(cfg.vocab_size, n=4, out_len=4)[0],
           **common)                                        # warm-up
    for name in ("synthetic", "shared-prefix", "spec-ngram"):
        kw = dict(common, **SERVE_KW[name])
        synth, shared = _workloads(cfg.vocab_size, n=16, out_len=32)
        reqs = shared if kw.get("prefix_caching") else synth
        ops.reset_launch_counts()
        stats, wall, info = _serve(cfg, asg, params, reqs, **kw)
        launched = ops.launch_counts()
        for k in counts:
            counts[k] += launched[k]
        _check_path(f"fp32-pool {name}", stats, launched,
                    info["draft_steps"], reqs, L, kw["n_slots"], kw)
        out_tok = sum(len(r.output) for r in reqs)
        log(f"  serve {cfg.name} bf16 on fp32 pools {name}: {len(reqs)} "
            f"requests, {out_tok} generated tokens in {wall:.3f} s wall "
            f"= {out_tok / wall:.1f} tok/s; {stats.summary()}; page pools "
            f"{stats.kv_bytes_resident / 2**30:.3f} GiB on {smi}; launches "
            f"{_nonzero(launched)}")
    del params
    torch.cuda.empty_cache()
    return counts


def phase_parity_jamba():
    """The synthetic workload on jamba-v0.1-52b at full width in fp32 (one
    period, 49.5 GiB of weights) through the kernels and through the plain
    versions: identical tokens and ServeStats counters, with the selective
    scan launched only by the kernel serve."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = _jamba(1, dtype="float32")
    asg = _jamba_asg()
    params = M.init_params(cfg, 0, device=DEVICE, dtype=torch.float32)
    common = dict(n_slots=8, max_len=2048, block_size=16,
                  dtype=torch.float32)
    outs = []
    for backend in ("kernel", "plain"):
        reqs = _workloads(cfg.vocab_size, n=6, out_len=8)[0]
        ops.reset_launch_counts()
        with ops.backend(backend):
            stats, wall, _ = _serve(cfg, asg, params, reqs, **common)
        scans = ops.launch_counts()["ssm_scan"]
        if (scans > 0) != (backend == "kernel"):
            raise AssertionError(f"jamba parity: the {backend} serve "
                                 f"launched the scan kernel {scans} times")
        outs.append(([list(r.output) for r in reqs], stats, wall))
    (tk, sk, wk), (tp, sp, wp) = outs
    prompts = [list(r.prompt) for r in reqs]
    if tk != tp:
        _parted(cfg, params, prompts, tk, tp,
                "jamba: the kernel and plain token streams")
    for f in PARITY_FIELDS:
        if getattr(sk, f) != getattr(sp, f):
            raise AssertionError(f"jamba: ServeStats.{f} differs: "
                                 f"{getattr(sk, f)} vs {getattr(sp, f)}")
    log(f"  parity jamba synthetic (fp32, full width, {cfg.num_layers} "
        f"layers): {len(tk)} requests x {len(tk[0])} tokens identical "
        f"through kernels ({wk:.3f} s) and plain versions ({wp:.3f} s); "
        f"{sk.summary()}")
    del params
    torch.cuda.empty_cache()


# the rest of the slot-mode zoo (phases 4 and 7)
ZOO = ("granite-20b", "granite-moe-3b-a800m", "codeqwen1.5-7b",
       "phi3.5-moe-42b-a6.6b", "xlstm-125m")


def _zoo(arch, num_layers, dtype=None):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=num_layers,
                               dtype=dtype or cfg.dtype)


def phase_parity_zoo():
    """Each zoo configuration at full width in fp32, 2 layers (xlstm-125m:
    one 4-layer period of three mLSTM layers and an sLSTM one), serves the
    synthetic workload through the kernels and through the plain versions:
    identical tokens and ServeStats counters, the attention kernels
    launched by the kernel serve only (xlstm-125m has no kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    for arch in ZOO:
        pattern = get_config(arch).layer_pattern
        L = len(pattern) if pattern else 2
        cfg = _zoo(arch, L, dtype="float32")
        asg = _pipeline_asg(L)
        params = M.init_params(cfg, 0, device=DEVICE, dtype=torch.float32)
        common = dict(n_slots=8, max_len=2048, block_size=16,
                      dtype=torch.float32)
        outs = []
        for backend in ("kernel", "plain"):
            reqs = _workloads(cfg.vocab_size, n=6, out_len=8)[0]
            ops.reset_launch_counts()
            with ops.backend(backend):
                stats, wall, _ = _serve(cfg, asg, params, reqs, **common)
            n = sum(ops.launch_counts().values())
            if (n > 0) != (backend == "kernel" and cfg.layer_pattern is None):
                raise AssertionError(f"{arch} parity: the {backend} serve "
                                     f"launched kernels {n} times")
            outs.append(([list(r.output) for r in reqs], stats, wall))
        (tk, sk, wk), (tp, sp, wp) = outs
        if tk != tp:
            _parted(cfg, params, [list(r.prompt) for r in reqs], tk, tp,
                    f"{arch}: the kernel and plain token streams")
        for f in PARITY_FIELDS:
            if getattr(sk, f) != getattr(sp, f):
                raise AssertionError(f"{arch}: ServeStats.{f} differs: "
                                     f"{getattr(sk, f)} vs {getattr(sp, f)}")
        log(f"  parity {arch} synthetic (fp32, full width, {L} layers): "
            f"{len(tk)} requests x {len(tk[0])} tokens identical through "
            f"kernels ({wk:.3f} s) and plain versions ({wp:.3f} s); "
            f"{sk.summary()}")
        del params
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: schedule -> plan -> from_config -> serve (the launcher's spine)
# ---------------------------------------------------------------------------

def phase_schedule_serve(smi):
    """The port's scheduler plans the FULL 80-layer llama2-70b on a GPU pool
    (the paper's setting); the plan is scaled to the served depth (8
    layers, published widths, bf16), built by InferenceEngine.from_config
    and serves the config's own Poisson workload on the wall clock. Then
    the launcher itself runs on the card in a subprocess. Returns the
    launch counts of the two serves, each zeroed just before its serve and
    read just after."""
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import scale_assignment
    from repro_torch.models import model as M
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import InferenceEngine
    cfg = _llama(SERVE_LAYERS)
    params = M.init_params(cfg, 0, device=DEVICE)    # ServingConfig.seed 0
    counts = dict.fromkeys(ops.KERNELS, 0)
    log(f"phase 5: schedule -> plan -> from_config -> serve, {cfg.name} at "
        f"full width, {cfg.num_layers} of 80 layers, {cfg.dtype}")
    # the launcher's paged settings on the paper's case-study pool, and a
    # shared-prefix workload (prefix caching, 256-token chunks) on the
    # half-price pool
    base = dict(arch="llama2-70b", cache_layout="paged", prompt_len=512,
                out_len=32, rate=2.0, duration=5.0, deadline=30.0)
    for name, sv in (
            ("paged", ServingConfig(cluster="case_study", search_iters=10,
                                    **base)),
            ("shared-prefix", ServingConfig(
                cluster="half_price", search_iters=4, prefix_caching=True,
                prefill_chunk=256, shared_prefix=1024, **base))):
        sv = sv.normalized()
        pool = sv.pool()
        t0 = time.perf_counter()
        res = schedule(pool, sv.arch, sv.task(), **sv.schedule_kwargs())
        search_s = time.perf_counter() - t0
        asg = scale_assignment(res.assignment, 80, cfg.num_layers)
        log(f"  schedule {name}: {sv.arch} (80 layers) on {sv.cluster} "
            f"({len(pool)} GPUs, ${pool.price_per_hour:.2f}/h), "
            f"{sv.search_iters} iterations: assignment "
            f"{res.assignment.describe()}, estimated SLO attainment "
            f"{res.attainment * 100:.1f}%, {res.evaluations} evaluations, "
            f"{search_s:.3f} s of host time; served as {asg.describe()}")
        reqs = sv.workload(cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        eng = InferenceEngine.from_config(cfg, res.plan, sv, assignment=asg,
                                          params=params, device=DEVICE)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        stats = eng.serve(reqs, deadline=sv.deadline)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for k in counts:
            counts[k] += launched[k]
        for r in reqs:
            if r.output is None or len(r.output) != sv.out_len:
                raise AssertionError(
                    f"schedule {name}: request {r.rid} got "
                    f"{None if r.output is None else len(r.output)} of "
                    f"{sv.out_len} tokens")
        if stats.rejected or stats.dropped:
            raise AssertionError(f"schedule {name}: {stats.summary()}")
        # with prefix caching every prompt takes the context path (#3), as
        # in the reference; the cold joint prefill (#1) runs without it
        need = ("paged_context_attention" if sv.prefix_caching
                else "flash_attention", "paged_decode_attention")
        for k in need:
            if not launched[k]:
                raise AssertionError(f"schedule {name}: {k} never ran; "
                                     f"launches {launched}")
        out_tok = sum(len(r.output) for r in reqs)
        in_tok = sum(len(r.prompt) for r in reqs)
        log(f"  serve {name}: {len(reqs)} requests ({in_tok} prompt + "
            f"{out_tok} generated tokens) arriving over {sv.duration} s, "
            f"served in {wall:.3f} s wall = {out_tok / wall:.1f} generated "
            f"tok/s, {(in_tok + out_tok) / wall:.1f} total tok/s; "
            f"{stats.iterations} iterations; {stats.summary()}; "
            f"launches {launched}")
        log(f"  memory {name}: {asg.num_replicas} replica(s) on the card "
            f"sharing one copy of the weights, page pools kv_bytes_resident "
            f"{stats.kv_bytes_resident} ({stats.kv_bytes_resident / 2**30:.3f}"
            f" GiB), peak device memory {peak / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated) on {smi}")
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    _run_launcher("llama2-70b")
    # K2: an unquantized pool of the other width than the model's: a bf16
    # pool under the reduced (fp32) model, an fp32 pool under a full-size
    # (bf16) one
    _run_launcher("llama2-70b", extra=["--kv-dtype", "bf16"])
    _run_launcher("granite-8b", extra=["--kv-dtype", "fp32"], reduced=False)
    return counts


def _run_launcher(arch, multi=False, extra=(), reduced=True):
    """``python -m repro_torch.launch.serve`` with phase 5's paged flags
    and `extra` on reduced `arch` (at full size unless `reduced`), in a
    subprocess on the card: it must exit 0 and print its assignment and
    summary lines. ``multi`` (phase 8 (c)) adds prefix
    caching, every multi-replica flag and every observability flag on the
    half-price pool: the launcher must also print its roles, its host-tier
    blocks and the calibration table, and ``python -m
    repro_torch.obs.report`` must pass the trace and metrics it writes
    under build/."""
    root = os.path.dirname(os.path.abspath(__file__))
    argv = ["--arch", arch] + (["--reduced"] if reduced else []) + [
        "--cluster", "half_price" if multi else "case_study",
        "--cache-layout", "paged", "--rate", "4", "--duration", "1",
        "--out-len", "4", "--search-iters", "2", *extra]
    out_dir = os.path.join(root, "build", "phase8")
    trace = os.path.join(out_dir, "launcher_trace.json")
    metrics = os.path.join(out_dir, "launcher_metrics.jsonl")
    if multi:
        os.makedirs(out_dir, exist_ok=True)
        argv += ["--prefix-caching", "--disaggregate", "--host-mem-gb", "1.0",
                 "--cluster-prefix", "--kvsan", "--trace-out", trace,
                 "--metrics-out", metrics, "--calibrate"]
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))

    def run(mod, args):
        out = subprocess.run([sys.executable, "-m", mod] + args, cwd=root,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        lines = out.stdout.splitlines()
        for line in lines:
            log(f"  cli | {line}")
        if out.returncode != 0:
            raise AssertionError(f"python -m {mod} exited {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        return lines

    t0 = time.perf_counter()
    lines = run("repro_torch.launch.serve", argv)
    if not (any(x.startswith("  assignment: ") for x in lines)
            and any(x.startswith("  n=") for x in lines)):
        raise AssertionError("the launcher printed no assignment or no "
                             "summary line")
    if multi:
        for want in ("  roles: ", "  host-tier blocks per replica: ",
                     "  trace: ", "  metrics: ",
                     "  calibration (predicted vs observed"):
            if not any(x.startswith(want) for x in lines):
                raise AssertionError(f"the launcher printed no {want!r} "
                                     "line")
    elif not lines[-1].startswith("  n="):
        raise AssertionError("the launcher's last line is not its summary")
    log(f"  cli: python -m repro_torch.launch.serve {' '.join(argv)} exited "
        f"0 in {time.perf_counter() - t0:.1f} s on the card")
    if multi:
        run("repro_torch.obs.report", [metrics, "--trace", trace,
                                       "--require-spans", "prefill,decode"])
        log("  cli: python -m repro_torch.obs.report passed the launcher's "
            "trace and metrics")


# ---------------------------------------------------------------------------
# Phase 6: the launcher's defaults: h2o-danube-1.8b, its window and its ring
# ---------------------------------------------------------------------------

DANUBE = "h2o-danube-1.8b"
D80 = ("flash_attention", "decode_attention")
# the long-prompt serve: prompts past the 4096-token window, 64 new tokens
# (the ring wraps), caches of at most 4672 positions
DANUBE_LENS, DANUBE_NEW, DANUBE_MAX_LEN = (4604, 4600, 4603, 4601), 64, 4672


def _danube_reqs(vocab, n, out_len=None, seed=0):
    """n requests at time 0 whose prompts cycle through DANUBE_LENS tokens
    (each static batch then pads its shorter prompts on the left), of
    out_len (None: DANUBE_NEW) new tokens each."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    lens = DANUBE_LENS
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=lens[i % len(lens)]).astype(np.int32),
        max_new_tokens=out_len or DANUBE_NEW) for i in range(n)]


def _static_margin(eng, reqs, max_batch, want, i, j):
    """The top-1 minus top-2 logit of request i's step j in its own static
    batch (the requests in order, max_batch at a time, left-padded), the
    batch decoded along `want`'s tokens: how near a tie the greedy choice
    that parted was."""
    b0 = i // max_batch * max_batch
    batch = reqs[b0:b0 + max_batch]
    s = max(len(r.prompt) for r in batch)
    toks = np.zeros((len(batch), s), np.int32)
    ks = np.array([s - len(r.prompt) for r in batch], np.int32)
    for row, r in enumerate(batch):
        toks[row, ks[row]:] = r.prompt
    rep = eng.replicas[0]
    logits = rep.prefill(toks, kv_start=ks, max_new=j + 1)
    for t in range(j):
        logits = rep.decode_step(np.array([want[b0 + row][t] for row in
                                           range(len(batch))], np.int32))
    top = np.sort(logits[i - b0])[-2:]
    return float(top[1] - top[0])


def phase_danube(smi):
    """The launcher's default flags serve h2o-danube-1.8b at full width and
    full depth (24 layers, d_model 2560, 32 / 8 heads of head dim 80, a
    4096-token sliding window) on the card: it has no slot mode, so the
    engine falls back to the paper's static whole-batch engine (with the
    reference's warning) on contiguous caches, the window's ring among
    them.

      (a) ``python -m repro_torch.launch.serve`` with no flags at all, in a
          subprocess: bf16, scheduled on the case-study pool, Poisson
          arrivals on the wall clock; it must exit 0 and print the
          reference's lines and a ServeStats summary;
      (b) 8 requests of 4600..4604-token prompts and 64 new tokens each, in
          static batches of 4, in-process in bf16: #1 runs with the window
          engaged (prompts past 4096 keys) and #8 on the ring after it
          wraps; walls, tokens/s, peak memory and launches logged, and the
          serve profiled;
      (c) the same in fp32 (batches of 2) through the kernels and through
          the plain versions: equal tokens, or a part where the greedy
          top-2 logit margin is within fp32 rounding (reported);
      (d) phase 3's llama2-70b (4 layers, bf16) on the contiguous layout,
          under continuous batching (slot pools: #1 on joint right-padded
          prefills, #8 on per-slot positions) and under policy="static"
          (#1 on left-padded prompts with kv_start, #8 with kv_start).

    Returns the launch counts of (b) and (d), and of (b) alone (head dim
    80), each serve's zeroed just before it and read just after."""
    import dataclasses
    import warnings
    from repro_torch.configs import get_config
    from repro_torch.core.plan import Assignment, PipelinePlan, StagePlan
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    counts = dict.fromkeys(ops.KERNELS, 0)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    log("phase 6: the launcher's defaults, h2o-danube-1.8b at full width "
        "and depth: its window and its ring")

    # (a) the launcher, no flags
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    lines = out.stdout.splitlines()
    for line in lines:
        log(f"  defaults | {line}")
    if out.returncode != 0:
        raise AssertionError(f"python -m repro_torch.launch.serve (no flags) "
                             f"exited {out.returncode}: {out.stderr[-2000:]}")
    if not (lines and lines[0].startswith(f"scheduling {DANUBE} on "
                                          "case_study")
            and any(x.startswith("  assignment: ") for x in lines)
            and lines[-1].startswith("  n=")
            and "policy='static'" in out.stderr):
        raise AssertionError("the launcher's default run printed no "
                             "schedule, assignment or summary line, or no "
                             f"static fallback warning: {out.stderr[-2000:]}")
    log(f"  defaults: python -m repro_torch.launch.serve exited 0 in "
        f"{time.perf_counter() - t0:.1f} s on the card (process start and "
        "scheduling included), with the static fallback warning")
    mark("phase 6 (a)")

    # (b) long prompts: the window and the ring
    cfg = get_config(DANUBE)
    asg = Assignment([PipelinePlan([StagePlan([0], cfg.num_layers)])])
    params = M.init_params(cfg, 0, device=DEVICE)
    n_params = sum(t.numel() for t in _leaves(params))
    lens = DANUBE_LENS
    kw = dict(cache_layout="contiguous", max_len=DANUBE_MAX_LEN, max_batch=4)
    log(f"  danube: {cfg.name}, {cfg.num_layers} layers, {n_params / 1e9:.3f}"
        f"e9 params {cfg.dtype} "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), window "
        f"{cfg.swa_window}, head dim {cfg.head_dim_}")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _serve(cfg, asg, params, _danube_reqs(cfg.vocab_size, 4, out_len=4), **kw)   # warm-up
    if not any("policy='static'" in str(w.message) for w in seen):
        raise AssertionError("no static fallback warning for h2o-danube")
    reqs = _danube_reqs(cfg.vocab_size, 8)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stats, wall, _ = _serve(cfg, asg, params, reqs, **kw)
    launched = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    d80 = dict(launched)
    for k in counts:
        counts[k] += launched[k]
    L, steps = cfg.num_layers, 2 * (DANUBE_NEW - 1)   # 2 batches
    if launched["flash_attention"] != 2 * L or \
            launched["decode_attention"] != steps * L:
        raise AssertionError(f"danube: #1 / #8 launched {launched}, "
                             f"expected {2 * L} / {steps * L}")
    out_tok = sum(len(r.output) for r in reqs)
    in_tok = sum(len(r.prompt) for r in reqs)
    log(f"  serve danube-long: {len(reqs)} requests ({in_tok} prompt tokens "
        f"of {min(lens)}..{max(lens)}, past the {cfg.swa_window}-token "
        f"window; {out_tok} generated, the ring wrapping) in static batches "
        f"of 4, {DANUBE_NEW} tokens each: {wall:.3f} s wall = {out_tok / wall:.1f} generated tok/s, "
        f"{(in_tok + out_tok) / wall:.1f} total tok/s; {stats.summary()}; "
        f"launches {launched}; peak device memory {peak / 2**30:.2f} GiB "
        f"on {smi}")
    mark("phase 6 (b) serve")
    # one batch of 16 tokens (the profiler's trace of the whole serve would
    # take a minute to sum up)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        profile_serve("danube-long (4 requests, 16 tokens)", cfg, asg,
                      params, _danube_reqs(cfg.vocab_size, 4, out_len=16),
                      **kw)
    del params
    torch.cuda.empty_cache()
    mark("phase 6 (b) profile")

    # (c) fp32: kernels against plain versions
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg32, 0, device=DEVICE)
    kw32 = dict(kw, max_batch=2)
    outs = []
    for backend in ("kernel", "plain"):
        reqs = _danube_reqs(cfg.vocab_size, 4, out_len=16)
        with ops.backend(backend), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            stats, wall, _ = _serve(cfg32, asg, params, reqs, **kw32)
        outs.append(([list(r.output) for r in reqs], stats, wall))
    (tk, sk, wk), (tp, sp, wp) = outs
    note = "identical"
    if tk != tp:
        i, j = next((i, j) for i, (a, b) in enumerate(zip(tp, tk))
                    for j, (x, y) in enumerate(zip(a, b)) if x != y)
        from repro_torch.serving.engine import InferenceEngine
        eng = InferenceEngine(cfg32, asg, params=params, device=DEVICE,
                              **kw32)
        margin = _static_margin(eng, reqs, 2, tp, i, j)
        del eng
        if margin > 1e-3:
            raise AssertionError(
                f"danube fp32: the kernel and plain token streams part for "
                f"request {i} at token {j} ({tk[i][j]} vs {tp[i][j]}); the "
                f"greedy top-2 logit margin there is {margin:.3g}")
        note = (f"parting for request {i} at token {j} at a near-tie "
                f"(greedy top-2 logit margin {margin:.3g})")
    for f in PARITY_FIELDS:
        if getattr(sk, f) != getattr(sp, f):
            raise AssertionError(f"danube fp32: ServeStats.{f} differs: "
                                 f"{getattr(sk, f)} vs {getattr(sp, f)}")
    log(f"  parity danube (fp32, full width and depth, static batches of 2 "
        f"left-padded prompts of {min(lens)}..{max(lens)} tokens): "
        f"{len(tk)} requests x {len(tk[0])} tokens {note} through kernels "
        f"({wk:.3f} s) and plain versions ({wp:.3f} s); {sk.summary()}")
    del params
    torch.cuda.empty_cache()
    mark("phase 6 (c)")

    # (d) llama2-70b on the contiguous layout: slot pools, then static
    cfg = _llama(SERVE_LAYERS)
    asg = _pipeline_asg(cfg.num_layers)
    params = M.init_params(cfg, 0, device=DEVICE)
    for name, kw in (("contiguous", dict(n_slots=16, max_len=2048)),
                     ("static", dict(policy="static", max_batch=4,
                                     max_len=2048))):
        reqs = _workloads(cfg.vocab_size, n=16, out_len=32)[0]
        ops.reset_launch_counts()
        stats, wall, _ = _serve(cfg, asg, params, reqs,
                                cache_layout="contiguous", **kw)
        launched = ops.launch_counts()
        for k in counts:
            counts[k] += launched[k]
        bad = [k for k in ops.KERNELS if (launched[k] > 0) != (k in D80)]
        if bad:
            raise AssertionError(f"llama {name}: {bad} launched {launched}")
        out_tok = sum(len(r.output) for r in reqs)
        log(f"  serve llama-{name} ({cfg.num_layers} layers, bf16): "
            f"{len(reqs)} requests, {out_tok} generated tokens in "
            f"{wall:.3f} s wall = {out_tok / wall:.1f} generated tok/s; "
            f"{stats.summary()}; launches {launched}")
    del params
    torch.cuda.empty_cache()
    return counts, d80


# ---------------------------------------------------------------------------
# Phase 7: the rest of the slot-mode zoo at full width
# ---------------------------------------------------------------------------

# each configuration's depth: the published one, but phi3.5-moe's 41.6e9
# parameters in bf16 (~83 GB) exceed the card's 80 GB: 8 of its 32 layers
# depth of phase 7's serves (full width): granite-20b 12 of its 52 layers
# and granite-moe-3b 8 of its 32 (cut from full depth so that the script
# stays within its time with the training phases), phi3.5-moe 8 of 32 (the
# whole model does not fit in bf16)
ZOO_LAYERS = {"granite-20b": 12, "granite-moe-3b-a800m": 8,
              "codeqwen1.5-7b": 32, "phi3.5-moe-42b-a6.6b": 8,
              "xlstm-125m": 12}
ZOO_SERVES = {"granite-20b": ("synthetic", "shared-prefix", "spec-ngram"),
              "granite-moe-3b-a800m": ("synthetic", "shared-prefix",
                                       "quant-int8"),
              "codeqwen1.5-7b": ("synthetic", "shared-prefix"),
              "phi3.5-moe-42b-a6.6b": ("synthetic",),
              "xlstm-125m": ("synthetic",)}
_PREFIX = dict(prefix_caching=True, prefill_chunk=256)
SERVE_KW = {"synthetic": {}, "shared-prefix": _PREFIX,
            "spec-ngram": dict(spec_decode=True, spec_k=4),
            "quant-int8": dict(_PREFIX, kv_dtype="int8")}
# the zoo's new GQA groups in the kernels line: (tag, architecture)
ZOO_TAGS = (("g48", "granite-20b"), ("g3", "granite-moe-3b-a800m"))
ZOO_ROWS = (("flash_attention", "g48"), ("paged_decode_attention", "g48"),
            ("paged_context_attention", "g48"),
            ("paged_verify_attention", "g48"), ("flash_attention", "g3"),
            ("paged_decode_attention", "g3"),
            ("paged_decode_attention_quant", "g3"),
            ("paged_context_attention_quant", "g3"))
ZOO_PROFILED = ("granite-20b", "granite-moe-3b-a800m")


def phase_zoo(smi):
    """The rest of the slot-mode zoo at full width in bf16, seeded weights,
    through the asymmetric 2-stage paged pipeline, one model at a time
    (depths: ZOO_LAYERS): granite-20b (12 of 52 layers; MQA, #1-#4 at g
    48) with the synthetic, shared-prefix and n-gram speculation
    workloads; granite-moe-3b-a800m (8 of 32 layers; g 3, 40 experts
    top-8) with the synthetic and
    shared-prefix ones, the latter also on int8 pages (#6, #5);
    codeqwen1.5-7b (all 32; q/k/v bias, MHA) synthetic and shared-prefix;
    phi3.5-moe-42b-a6.6b (8 of 32 layers) synthetic; xlstm-125m (all 12;
    recurrent slot rows only, no kernel) synthetic. Phase 3's workloads;
    every kernel of a serve's path must run layers x steps times, counted
    from 0 just before the serve. Then the launcher on reduced
    granite-moe-3b-a800m. Returns the launch counts of all serves, and of
    granite-20b's and granite-moe's alone by tag (ZOO_TAGS)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    counts = dict.fromkeys(ops.KERNELS, 0)
    by_tag = {}
    common = dict(n_slots=16, max_len=2048, block_size=16)
    for arch in ZOO:
        cfg = _zoo(arch, ZOO_LAYERS[arch])
        L = cfg.num_layers
        asg = _pipeline_asg(L)
        params = M.init_params(cfg, 0, device=DEVICE)
        n_params = sum(t.numel() for t in _leaves(params))
        log(f"phase 7: {arch} at full width, {L} of "
            f"{get_config(arch).num_layers} layers, "
            f"{n_params / 1e9:.2f}e9 params {cfg.dtype} "
            f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), stages "
            f"{asg.pipelines[0].layer_split}, hq {cfg.num_heads} / hkv "
            f"{cfg.num_kv_heads}, head dim {cfg.head_dim_}")
        names = ZOO_SERVES[arch]
        for kw in [{}] + [SERVE_KW[n] for n in names if n == "spec-ngram"]:
            _serve(cfg, asg, params,                         # warm-up
                   _workloads(cfg.vocab_size, n=4, out_len=4)[0], **common,
                   **kw)
        tag = dict((a, t) for t, a in ZOO_TAGS).get(arch)
        attn = cfg.attn_layer_ids
        for name in names:
            kw = SERVE_KW[name]
            synth, shared = _workloads(cfg.vocab_size, n=16, out_len=32)
            reqs = shared if kw.get("prefix_caching") else synth
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            stats, wall, info = _serve(cfg, asg, params, reqs, **common,
                                       **kw)
            launched = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            for k in counts:
                counts[k] += launched[k]
            if tag:
                tc = by_tag.setdefault(tag, dict.fromkeys(ops.KERNELS, 0))
                for k in tc:
                    tc[k] += launched[k]
            out_tok = sum(len(r.output) for r in reqs)
            in_tok = sum(len(r.prompt) for r in reqs)
            acc = (f"; accept rate "
                   f"{stats.spec_accepted / stats.spec_proposed:.3f}, "
                   f"{out_tok / stats.spec_steps:.2f} tokens per slot step"
                   if stats.spec_proposed else "")
            log(f"  serve {arch} {name}: {len(reqs)} requests, {in_tok} "
                f"prompt + {out_tok} generated tokens in {wall:.3f} s wall "
                f"= {out_tok / wall:.1f} generated tok/s, "
                f"{(in_tok + out_tok) / wall:.1f} total tok/s; "
                f"{stats.iterations} iterations; {stats.summary()}{acc}; "
                f"weights {info['weight_bytes'] / 2**30:.2f} GiB, page pools "
                f"{stats.kv_bytes_resident / 2**30:.3f} GiB, slot state "
                f"{info['state_bytes'] / 2**20:.1f} MiB, peak device memory "
                f"{peak / 2**30:.2f} GiB on {smi}; launches {launched}")
            if attn:
                _check_path(f"{arch} {name}", stats, launched,
                            info["draft_steps"], reqs, len(attn),
                            common["n_slots"], kw)
            elif sum(launched.values()) or not info["state_bytes"]:
                raise AssertionError(f"{arch}: {launched} launches, "
                                     f"{info['state_bytes']} bytes of slot "
                                     "state")
        if arch in ZOO_PROFILED:
            profile_serve(f"{arch} synthetic", cfg, asg, params,
                          _workloads(cfg.vocab_size, n=16, out_len=32)[0],
                          **common)
        del params
        torch.cuda.empty_cache()
        mark(f"phase 7 {arch}")
    _run_launcher("granite-moe-3b-a800m")
    return counts, by_tag


# ---------------------------------------------------------------------------
# Phase 8: disaggregated prefill/decode, the host page tier with the
# cluster prefix directory, KVSAN, and observability
# ---------------------------------------------------------------------------

MULTI_SPLITS = ((1, 1), (2,))     # (a): the two replicas' stage splits
# the prompt families of the tiered serves: how many, and their shared and
# unique tokens
FAMILIES, FAMILY_SHARED, FAMILY_UNIQUE = 3, 1024, 64


def _multi_asg(L, splits):
    """One replica per entry of `splits` (each a tuple of stage layer
    counts), every stage on its own device id."""
    from repro_torch.core.plan import Assignment, PipelinePlan, StagePlan
    pipes, d = [], 0
    for split in splits:
        stages = []
        for n in split:
            stages.append(StagePlan([d], n))
            d += 1
        pipes.append(PipelinePlan(stages))
    return Assignment(pipes)


def _families(vocab, n, out_len, gap=40.0):
    """n requests of FAMILIES prompt families (a shared prefix of
    FAMILY_SHARED tokens each, then FAMILY_UNIQUE tokens of the request's
    own), taking the families in turn and arriving in pairs every `gap`
    units of the virtual clock. Two replicas that each keep at most one
    shared set on the device (``_tiered``) cannot settle on a family
    each, wherever the router sends a request: serving another family
    spills a shared set to the host tier, and a family that comes back
    finds its prefix there, on the peer, or nowhere."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(0)
    shared = [rng.integers(0, vocab, size=FAMILY_SHARED).astype(np.int32)
              for _ in range(FAMILIES)]
    reqs = []
    for i in range(n):
        prompt = np.concatenate([shared[i % FAMILIES], rng.integers(
            0, vocab, size=FAMILY_UNIQUE).astype(np.int32)])
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=out_len,
                            arrival=gap * (i // 2)))
    return reqs


def _tiered(out_len, kvsan=False, block_size=16):
    """Engine kwargs of the tiered, clustered serves: prefix caching with
    256-token chunks, a 256-block host tier under every replica, the
    cluster prefix directory (an ideal link) with the Router's
    prefix-aware dispatch, and one slot whose ``max_len`` sizes each
    stage pool (the engine's default, max_len // block_size + 1 blocks)
    to one family request and a block to spare: never two shared sets."""
    def blocks(n):
        return -(-n // block_size)
    max_blocks = blocks(FAMILY_SHARED + FAMILY_UNIQUE + out_len) + 1
    assert max_blocks < 2 * blocks(FAMILY_SHARED)
    return dict(n_slots=1, max_len=max_blocks * block_size,
                block_size=block_size, prefix_caching=True,
                prefill_chunk=256, host_blocks=256, cluster_prefix=True,
                kvsan=kvsan)


def _kv_block_bytes(cfg, block_size, elem_bytes, scales=False):
    """Bytes of one block of K and V pages over every layer, with the
    float32 per-row, per-head scales of a quantized pool."""
    row = cfg.num_kv_heads * (cfg.head_dim_ * elem_bytes + 4 * scales)
    return 2 * cfg.num_layers * block_size * row


def _check_tiers(name, stats):
    if not stats.host_demotions:
        raise AssertionError(f"{name}: no page spilled to the host tier; "
                             f"{stats.summary()}")
    if not stats.host_promotions + stats.prefix_fetches:
        raise AssertionError(f"{name}: no page promoted from the host tier "
                             f"or fetched from the peer; {stats.summary()}")


def _check_launched(name, need):
    """Raise unless every kernel in `need` launched since the counts were
    last reset."""
    from repro_torch.kernels import ops
    launched = ops.launch_counts()
    for k in need:
        if not launched[k]:
            raise AssertionError(f"{name}: {k} never ran; {launched}")


MULTI_FIELDS = PARITY_FIELDS + ("migrations", "migrated_kv_bytes",
                                "host_demotions", "host_promotions",
                                "host_evictions", "host_hit_tokens",
                                "prefix_fetches", "prefix_fetched_bytes")


def phase_multi_parity():
    """Phase 8 (a): llama2-70b at full width, 2 layers, fp32, two replicas
    on the card with stage splits [1, 1] and [2], on model-precision,
    int8 and fp8 page pools. Through the kernels and through the plain
    versions, each with KVSAN off and on: a colocated synthetic serve;
    the same disaggregated (replica 0 prefills, replica 1 decodes) must
    give its tokens, migrate every request once and ship exactly blocks x
    bytes per block at the pool's width (scales included); a serve of
    three prompt families through the engine with prefix caching, host
    tiers, the cluster directory and prefix-aware dispatch, over one-slot
    pools that hold one shared set, must give the tokens of the untiered
    serve (one replica, one slot, prefix caching, pools for every block)
    while spilling to the host and promoting or fetching back. On
    quantized pools the synthetic requests are served one at a time (see
    below), and the quantized decode and context kernels (#5, #6) must
    have run on the migrated, promoted and fetched pages. KVSAN must stay
    silent, and every serve must give the same tokens and counters
    through the plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = _llama(2)
    asg = _multi_asg(cfg.num_layers, MULTI_SPLITS)
    params = M.init_params(cfg, 0, device=DEVICE, dtype=torch.float32)
    common = dict(n_slots=8, max_len=2048, block_size=16,
                  dtype=torch.float32)
    log(f"phase 8 (a): {cfg.name} at full width, 2 layers, fp32, replicas "
        f"{[p.layer_split for p in asg.pipelines]}, pools fp32 / int8 / "
        "fp8")
    want, streams = {}, {}     # the kernels' counters and tokens by serve

    def same_as_kernels(name, backend, got):
        if streams.setdefault(name, got) != got:
            raise AssertionError(f"{name}: the {backend} tokens differ from "
                                 "the kernels'")
    def synthetic(alone):
        synth, _ = _workloads(cfg.vocab_size, n=6, out_len=8)
        if alone:
            for i, r in enumerate(synth):
                r.arrival = 1e3 * i
        return synth
    for kv in (None, "int8", "fp8"):
        pool = dict(common, kv_dtype=kv)
        block_bytes = _kv_block_bytes(cfg, 16, 1, scales=True) if kv \
            else _kv_block_bytes(cfg, 16, 4)
        sfx = "_quant" if kv else ""
        need = ("paged_decode_attention" + sfx,
                "paged_context_attention" + sfx)
        # A one-byte page rounds each value to a few mantissa bits, so a
        # last-bit difference from a GEMM run at another batch size can
        # move a page value by a whole step and a near-tied greedy choice
        # with it. On quantized pools every synthetic request is served
        # alone (arrivals 1e3 apart): the serves compared then run the
        # same batch shapes and differ only in where the pages come from.
        # The batched colocated serve is logged beside it.
        alone = kv is not None
        for backend in ("kernel", "plain"):
            with ops.backend(backend):
                synth = synthetic(alone)
                _, wc, _ = _serve(cfg, asg, params, synth, **pool)
                toks = [list(r.output) for r in synth]
                same_as_kernels((kv, "colocated"), backend, toks)
                prompts = [list(r.prompt) for r in synth]
                batched = ""
                if alone:
                    synth = synthetic(False)
                    _serve(cfg, asg, params, synth, **pool)
                    n = sum(list(r.output) == t for r, t in zip(synth, toks))
                    batched = (f"; batched colocated: {n}/{len(synth)} "
                               "streams equal the alone serve's")
                fams = _families(cfg.vocab_size, 8, 8)
                _serve(cfg, _multi_asg(2, ((2,),)), params, fams,
                       **dict(_tiered(8), host_blocks=0,
                              cluster_prefix=False, stage_blocks=[512]),
                       dtype=torch.float32, kv_dtype=kv)
                cold = [list(r.output) for r in fams]
                same_as_kernels((kv, "untiered"), backend, cold)
                for kvsan in (False, True):
                    synth = synthetic(alone)
                    ops.reset_launch_counts()
                    dis, wd, di = _serve(cfg, asg, params, synth, **pool,
                                         roles=["prefill", "decode"],
                                         kv_link_gbps=100.0, kvsan=kvsan)
                    if backend == "kernel":
                        _check_launched(f"disaggregated kv={kv}", need[:1])
                    got = [list(r.output) for r in synth]
                    if got != toks:
                        _parted(cfg, params, prompts, got, toks,
                                f"{backend} kv={kv} kvsan={kvsan}: the "
                                "disaggregated and colocated token streams")
                    nbytes = sum(-(-len(r.prompt) // 16) for r in synth) \
                        * block_bytes
                    if dis.migrations != len(synth) \
                            or dis.migrated_kv_bytes != nbytes:
                        raise AssertionError(
                            f"disaggregated kv={kv}: {dis.migrations} "
                            f"migrations of {dis.migrated_kv_bytes} B, want "
                            f"{len(synth)} of {nbytes} B")
                    fams = _families(cfg.vocab_size, 8, 8)
                    ops.reset_launch_counts()
                    tier, wt, ti = _serve(cfg, asg, params, fams,
                                          dtype=torch.float32, kv_dtype=kv,
                                          **_tiered(8, kvsan=kvsan))
                    if backend == "kernel":
                        _check_launched(f"tiered kv={kv}", need)
                    got = [list(r.output) for r in fams]
                    if got != cold:
                        _parted(cfg, params, [list(r.prompt) for r in fams],
                                got, cold, f"{backend} kv={kv} kvsan={kvsan}"
                                ": the tiered and untiered token streams")
                    _check_tiers(f"tiered kv={kv}", tier)
                    if kvsan and (dis.kvsan_leaks or tier.kvsan_leaks
                                  or di["kvsan_violations"]
                                  or ti["kvsan_violations"]):
                        raise AssertionError("KVSAN reported on a clean "
                                             "serve")
                    for key, st in (((kv, "dis", kvsan), dis),
                                    ((kv, "tier", kvsan), tier)):
                        want.setdefault(key, st)
                        for f in MULTI_FIELDS:
                            if getattr(st, f) != getattr(want[key], f):
                                raise AssertionError(
                                    f"{key} {backend}: ServeStats.{f} "
                                    "differs from the kernels' serve")
                    log(f"  parity {backend} kv={kv} kvsan={kvsan}: "
                        f"disaggregated == colocated ({len(synth)} x 8 "
                        f"tokens, {dis.migrations} migrations, "
                        f"{dis.migrated_kv_bytes} B = blocks x "
                        f"{block_bytes} B; {wd:.3f} s, colocated {wc:.3f} "
                        f"s); tiered + cluster == untiered ({len(fams)} "
                        f"requests; {tier.host_demotions} spilled, "
                        f"{tier.host_promotions} promoted, "
                        f"{tier.prefix_fetches} fetched, "
                        f"{tier.prefix_fetched_bytes} B; {wt:.3f} s); "
                        f"{tier.summary()}{batched}")
    del params
    torch.cuda.empty_cache()


def phase_multi(smi):
    """Phase 8 (b) and (c): llama2-70b at full width in bf16, SERVE_LAYERS
    layers, two replicas with splits [1, 3] and [4] sharing one copy of
    the weights. After a short warm-up serve of each layout, phase 3's 16
    synthetic requests x 32 tokens served colocated and disaggregated
    (replica 0 prefills, replica 1 decodes, a 100 Gbit/s link modelled on
    the virtual clock) three times each, the order alternating; 8
    requests of FAMILIES families of FAMILY_SHARED shared +
    FAMILY_UNIQUE unique tokens through the engine with host tiers, the
    cluster directory and prefix-aware dispatch over pools that hold one
    shared set (``_tiered``); each of the three once more under
    torch.profiler; and one colocated serve traced on the wall clock
    into a metrics registry. Then the launcher with every multi-replica
    and observability flag in a subprocess, and the report CLI on its
    artifacts. Returns the launch counts of the measured serves, each
    zeroed just before it and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer, validate_chrome_trace
    cfg = _llama(SERVE_LAYERS)
    L = cfg.num_layers
    lo = _pipeline_asg(L).pipelines[0].layer_split
    asg = _multi_asg(L, (tuple(lo), (L,)))
    params = M.init_params(cfg, 0, device=DEVICE)
    common = dict(n_slots=16, max_len=2048, block_size=16)
    layouts = {"colocated": {},
               "disaggregated": dict(roles=["prefill", "decode"],
                                     kv_link_gbps=100.0)}
    counts = dict.fromkeys(ops.KERNELS, 0)
    log(f"phase 8 (b): {cfg.name} at full width, {L} of 80 layers, "
        f"{cfg.dtype}, replicas {[p.layer_split for p in asg.pipelines]} "
        f"on {smi}")

    def measured(name, run, need):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = run()
        launched = ops.launch_counts()
        for k in counts:
            counts[k] += launched[k]
        for k in need:
            if not launched[k]:
                raise AssertionError(f"{name}: {k} never ran; {launched}")
        return out, launched, torch.cuda.max_memory_allocated()

    for kw in layouts.values():                 # warm-up, both layouts
        synth, _ = _workloads(cfg.vocab_size, n=4, out_len=4)
        _serve(cfg, asg, params, synth, **common, **kw)
    walls = {name: [] for name in layouts}
    outs = {name: [] for name in layouts}
    for rep in range(3):
        order = list(layouts) if rep % 2 == 0 else list(layouts)[::-1]
        for name in order:
            synth, _ = _workloads(cfg.vocab_size, n=16, out_len=32)
            (st, wall, _), launched, peak = measured(
                name, lambda: _serve(cfg, asg, params, synth, **common,
                                     **layouts[name]),
                ("flash_attention", "paged_decode_attention"))
            walls[name].append(wall)
            outs[name].append([list(r.output) for r in synth])
            if name == "disaggregated":
                if st.migrations != len(synth):
                    raise AssertionError(
                        f"disaggregated: {st.migrations} migrations for "
                        f"{len(synth)} requests")
                dis, dis_launched, dis_peak = st, launched, peak
    in_tok = sum(len(r.prompt) for r in synth)
    out_tok = sum(len(r.output) for r in synth)
    wd = float(np.median(walls["disaggregated"]))
    wc = float(np.median(walls["colocated"]))
    same = sum(a == b for a, b in zip(outs["disaggregated"][0],
                                      outs["colocated"][0]))
    log(f"  serve disaggregated vs colocated, 3 serves each (order c d, "
        f"d c, c d after a warm-up of each): {len(synth)} requests, "
        f"{in_tok} prompt + {out_tok} generated tokens; walls "
        f"disaggregated {[round(w, 4) for w in walls['disaggregated']]} "
        f"s, colocated {[round(w, 4) for w in walls['colocated']]} s; "
        f"median disaggregated {wd:.3f} s = {out_tok / wd:.1f} generated "
        f"tok/s, {(in_tok + out_tok) / wd:.1f} total tok/s, colocated "
        f"{wc:.3f} s = {out_tok / wc:.1f} / {(in_tok + out_tok) / wc:.1f};"
        f" {dis.migrations} migrations, "
        f"{dis.migrated_kv_bytes / 2**30:.3f} GiB migrated; {same}/"
        f"{len(synth)} outputs equal the colocated serve's; repeats give "
        f"their layout's first tokens: "
        f"{all(o == outs[n][0] for n in layouts for o in outs[n])}; "
        f"{dis.summary()}; peak device memory {dis_peak / 2**30:.2f} GiB;"
        f" launches {dis_launched}")
    fams = _families(cfg.vocab_size, 8, 32, gap=60.0)
    (tier, wt, _), launched, peak = measured(
        "shared-prefix tiered",
        lambda: _serve(cfg, asg, params, fams, **_tiered(32)),
        ("paged_context_attention", "paged_decode_attention"))
    _check_tiers("shared-prefix tiered", tier)
    in_tok = sum(len(r.prompt) for r in fams)
    out_tok = sum(len(r.output) for r in fams)
    log(f"  serve shared-prefix tiered: {len(fams)} requests, {in_tok} "
        f"prompt + {out_tok} generated tokens in {wt:.3f} s wall = "
        f"{out_tok / wt:.1f} generated tok/s, {(in_tok + out_tok) / wt:.1f}"
        f" total tok/s; prefill tokens {tier.prefill_tokens} of {in_tok} "
        f"({in_tok - tier.prefill_tokens} saved: {tier.prefix_hit_tokens} "
        f"prefix-hit tokens, {tier.host_hit_tokens} from the host tier); "
        f"{tier.host_demotions} blocks spilled, {tier.host_promotions} "
        f"promoted, {tier.host_evictions} dropped, {tier.prefix_fetches} "
        f"fetched ({tier.prefix_fetched_bytes / 2**20:.1f} MiB); "
        f"{tier.summary()}; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launched}")
    for name, kw in layouts.items():
        synth, _ = _workloads(cfg.vocab_size, n=16, out_len=32)
        profile_serve(name, cfg, asg, params, synth, **common, **kw)
    profile_serve("shared-prefix tiered", cfg, asg, params,
                  _families(cfg.vocab_size, 8, 32, gap=60.0), **_tiered(32))
    tracer, metrics = Tracer(), MetricsRegistry()
    synth, _ = _workloads(cfg.vocab_size, n=16, out_len=32)
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, asg, params=params, device=DEVICE,
                          cache_layout="paged", **common)

    def traced():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.serve(synth, deadline=60.0, tracer=tracer, metrics=metrics)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0
    (st, wall), launched, _ = measured(
        "traced", traced, ("flash_attention", "paged_decode_attention"))
    del eng
    errs = validate_chrome_trace(tracer.to_chrome(), require_spans=[
        "serve", "queue_wait", "iteration", "prefill", "decode"])
    if errs:
        raise AssertionError(f"traced serve: {errs[:5]}")
    if metrics.total("serve_n_requests") != len(synth) \
            or any(r.output is None or len(r.output) != r.max_new_tokens
                   for r in synth):
        raise AssertionError(f"traced serve: {st.summary()}")
    spans = collections.Counter(e["name"] for e in tracer.events)
    serve_s = next(e["dur"] for e in tracer.events if e["name"] == "serve")
    waits = [e["dur"] for e in tracer.events if e["name"] == "queue_wait"]
    # as in the reference, the engines' spans (prefill, decode, iteration)
    # carry the virtual step cost they charge, on a wall clock too; the
    # serve and queue-wait spans are sampled from the clock
    log(f"  serve traced (wall clock, tracer and metrics on): "
        f"{len(synth)} requests in {wall:.3f} s; {len(tracer.events)} "
        f"events {dict(spans)}; serve span {serve_s:.3f} s, queue wait "
        f"mean {np.mean(waits) * 1e3:.2f} ms; {len(metrics.collect())} "
        f"metric rows; {st.summary()}")
    del params
    torch.cuda.empty_cache()
    _run_launcher("llama2-70b", multi=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 9: online rescheduling; whisper-base and paligemma-3b
# ---------------------------------------------------------------------------

# (a): requests arrive in pairs CHAOS_GAP units of the virtual clock apart
# (an iteration costs one); the first of a pair (8 prompt tokens) lands on
# replica 0, the second (16) on replica 1, each prefilled alone in chunks
# of CHAOS_CHUNK tokens
CHAOS_GAP, CHAOS_CHUNK = 30.0, 4
CHAOS_ENGINE = dict(n_slots=4, max_len=64, block_size=8,
                    prefill_chunk=CHAOS_CHUNK, kvsan=True,
                    dtype=torch.float32)


def _chaos_reqs(vocab, out_len):
    """Two pairs of requests (phase 9 (a)): prompts of 8 and 16 tokens
    at t = 0 and t = CHAOS_GAP. Each replica prefills one prompt at a time,
    alone, in the serve without a controller and in every scenario below,
    so the batch shapes of a prefill never change between the serves
    compared (a last-bit difference from a GEMM of another shape can move
    a one-byte page value by a whole step and a near-tied greedy choice
    with it; decode runs every slot's row at every step)."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(2)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=8 if i % 2 == 0 else 16).astype(np.int32),
        max_new_tokens=out_len, arrival=CHAOS_GAP * (i // 2))
        for i in range(4)]


def _resplit_controller(min_events=4, window=2 * CHAOS_GAP):
    """The chaos smoke's live re-split (scripts/smoke_serving.py:498-513):
    a drift detector planned for 1 request a unit of time fires once
    `min_events` admissions are in its window (in (a) the second pair's:
    a rate far below plan) and the resolver, once, splits the colocated
    pair into a prefill replica 0 and a decode replica 1, moving replica
    0's decoding slots to replica 1 live."""
    from repro_torch.core.resched import DriftDetector
    from repro_torch.serving.resched import OnlineRescheduler
    fired = []

    def resolver(sig, ctl, now):
        if fired:
            return None
        fired.append(sig.kind)
        return {"roles": ["prefill", "decode"]}
    return OnlineRescheduler(
        detector=DriftDetector(rate=1.0, min_events=min_events,
                               window=window), resolver=resolver)


def _chaos_scenarios():
    """name -> (out_len, controller factory): replica 1 killed while the
    second pair's 16-token prompt is mid-prefill (its second of four
    chunks done) and while it decodes; the live re-split while the first
    pair decodes (40 tokens each)."""
    from repro_torch.serving.resched import OnlineRescheduler
    return {"kill mid-prefill": (12, lambda: OnlineRescheduler(
                kills=[(CHAOS_GAP + 0.5, 1)])),
            "kill mid-decode": (12, lambda: OnlineRescheduler(
                kills=[(CHAOS_GAP + 6.0, 1)])),
            "live re-split": (40, _resplit_controller)}


def phase_chaos_parity():
    """Phase 9 (a): online rescheduling on llama2-70b at full width, 2
    layers, fp32, on the chaos topology (tests/test_resched.py:317-324: two
    replicas whose stage splits cross, [1, L - 1] and [L - 1, 1]), paged,
    chunked prefill, KVSAN on, on model-precision, int8 and fp8 pools,
    through the kernels and through the plain versions: a kill of replica
    1 mid-prefill, a kill mid-decode and a live role re-split mid-decode
    must give the streams of the serve without a controller, leak no
    page, re-dispatch the killed replica's requests (orphans > 0) and
    move decoding slots (moved > 0), and give the same counters and
    controller events through the plain versions as through the kernels.
    On quantized pools the quantized context and decode kernels (#6, #5)
    must run in every scenario, #5 on the moved pages."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.loop import ServeStats
    cfg = _llama(2)
    L = cfg.num_layers
    asg = _multi_asg(L, ((1, L - 1), (L - 1, 1)))
    params = M.init_params(cfg, 0, device=DEVICE, dtype=torch.float32)
    fields = [f.name for f in dataclasses.fields(ServeStats)]
    log(f"phase 9 (a): {cfg.name} at full width, {L} layers, fp32, "
        f"replicas {[p.layer_split for p in asg.pipelines]}, paged, "
        f"chunks of {CHAOS_CHUNK}, KVSAN on, pools fp32 / int8 / fp8")
    for kv in (None, "int8", "fp8"):
        sfx = "_quant" if kv else ""
        need = ("paged_context_attention" + sfx,
                "paged_decode_attention" + sfx)
        want = {}
        for backend in ("kernel", "plain"):
            with ops.backend(backend):
                cold = {}
                for out_len in (12, 40):
                    reqs = _chaos_reqs(cfg.vocab_size, out_len)
                    _serve(cfg, asg, params, reqs, kv_dtype=kv,
                           **CHAOS_ENGINE)
                    cold[out_len] = [list(r.output) for r in reqs]
                for name, (out_len, make) in _chaos_scenarios().items():
                    reqs = _chaos_reqs(cfg.vocab_size, out_len)
                    ctl = make()
                    ops.reset_launch_counts()
                    st, wall, info = _serve(cfg, asg, params, reqs,
                                            controller=ctl, kv_dtype=kv,
                                            **CHAOS_ENGINE)
                    launched = ops.launch_counts()
                    got = [list(r.output) for r in reqs]
                    what = f"{backend} kv={kv} {name}"
                    if got != cold[out_len]:
                        _parted(cfg, params, [list(r.prompt) for r in reqs],
                                got, cold[out_len], f"{what}: the streams "
                                "and those without a controller")
                    if st.kvsan_leaks or info["kvsan_violations"]:
                        raise AssertionError(f"{what}: KVSAN reported "
                                             f"{st.summary()}")
                    kinds = {e["kind"]: e for e in ctl.events}
                    if name.startswith("kill"):
                        if not (kinds.get("kill", {}).get("orphans", 0) > 0
                                and ctl.redispatches > 0):
                            raise AssertionError(f"{what}: {ctl.events}, "
                                                 f"{ctl.redispatches} "
                                                 "re-dispatches")
                    elif not (kinds.get("roles", {}).get("moved", 0) > 0
                              and st.migrations > 0):
                        raise AssertionError(f"{what}: {ctl.events}")
                    if backend == "kernel":
                        _check_launched(what, need)
                    run = ([getattr(st, f) for f in fields], ctl.events,
                           ctl.redispatches, got)
                    if want.setdefault(name, run) != run:
                        raise AssertionError(f"{what}: counters, events or "
                                             "tokens differ from the "
                                             "kernels' serve")
                    log(f"  chaos {what}: tokens == without a controller "
                        f"({len(reqs)} x {out_len}); events {ctl.events}; "
                        f"{ctl.redispatches} re-dispatched, "
                        f"{st.migrations} moved ({st.migrated_kv_bytes} B);"
                        f" {wall:.3f} s; {st.summary()}; launches "
                        f"{launched}")
    del params
    torch.cuda.empty_cache()


def phase_chaos(smi):
    """Phase 9 (b): llama2-70b at full width in bf16, SERVE_LAYERS layers,
    replicas [1, 3] and [4], phase 3's 16 synthetic requests x 32 tokens:
    served without a controller, with replica 1 killed mid-decode (t = 10:
    its requests re-prefill on replica 0), and with a live role re-split
    (a drift detector planned for one request a unit of time fires at the
    12th admission; replica 0's decoding slots move to replica 1). Every
    request must finish, #1 and #2 must run, the kill must orphan and
    re-dispatch requests and the re-split move slots. The walls and how
    many streams equal the serve without a controller are logged, not
    gated: in bf16 a changed batch shape may part a stream at a near-tie.
    Returns the launch counts of the three serves."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.resched import OnlineRescheduler
    cfg = _llama(SERVE_LAYERS)
    L = cfg.num_layers
    lo = _pipeline_asg(L).pipelines[0].layer_split
    asg = _multi_asg(L, (tuple(lo), (L,)))
    params = M.init_params(cfg, 0, device=DEVICE)
    common = dict(n_slots=16, max_len=2048, block_size=16)
    counts = dict.fromkeys(ops.KERNELS, 0)
    log(f"phase 9 (b): {cfg.name} at full width, {L} of 80 layers, "
        f"{cfg.dtype}, replicas {[p.layer_split for p in asg.pipelines]} "
        f"on {smi}")

    runs = (("without a controller", lambda: None),
            ("kill mid-decode", lambda: OnlineRescheduler(kills=[(10.0, 1)])),
            ("live re-split", lambda: _resplit_controller(12, 5.0)))
    base = None
    for name, make in runs:
        synth, _ = _workloads(cfg.vocab_size, n=16, out_len=32)
        ctl = make()
        ops.reset_launch_counts()
        st, wall, info = _serve(cfg, asg, params, synth, controller=ctl,
                                **common)
        launched = ops.launch_counts()
        for k in counts:
            counts[k] += launched[k]
        _check_launched(name, ("flash_attention", "paged_decode_attention"))
        outs = [list(r.output) for r in synth]
        base = outs if base is None else base
        events = [] if ctl is None else ctl.events
        kinds = {e["kind"]: e for e in events}
        if name.startswith("kill") and not (
                kinds.get("kill", {}).get("orphans", 0) > 0
                and ctl.redispatches > 0):
            raise AssertionError(f"{name}: {events}")
        if name == "live re-split" and not kinds.get("roles", {}).get(
                "moved", 0):
            raise AssertionError(f"{name}: {events}")
        if st.kvsan_leaks:
            raise AssertionError(f"{name}: {st.summary()}")
        in_tok = sum(len(r.prompt) for r in synth)
        out_tok = sum(len(r.output) for r in synth)
        same = sum(a == b for a, b in zip(outs, base))
        log(f"  chaos bf16 {name}: {len(synth)} requests, {in_tok} prompt "
            f"+ {out_tok} generated tokens in {wall:.3f} s wall = "
            f"{out_tok / wall:.1f} generated tok/s; {same}/{len(synth)} "
            f"streams equal the serve without a controller; events "
            f"{events}; {st.migrations} moved "
            f"({st.migrated_kv_bytes / 2**20:.1f} MiB); {st.summary()}; "
            f"launches {launched}")
    del params
    torch.cuda.empty_cache()
    return counts


# (c): the two families at full width in bf16 (whisper-base all 6 + 6
# layers, paligemma-3b all 18) and at 2 layers in fp32
ENCDEC = ("whisper-base", "paligemma-3b")
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_NEW = 4, 32, 32
ENCDEC_FP32_ATOL = 2e-4     # tests/test_serving.py:24-50's prefill bound


def _encdec_cfg(arch, layers=None, dtype=None):
    """`arch` at its published widths, depth cut to `layers` (whisper's
    encoder too) when given."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    kw = {} if dtype is None else dict(dtype=dtype)
    if layers is not None:
        kw["num_layers"] = layers
        if cfg.is_encoder_decoder:
            kw["num_encoder_layers"] = layers
    return dc.replace(cfg, **kw)


def _encdec_inputs(cfg, seed=0):
    """ENCDEC_BATCH seeded prompts of ENCDEC_PROMPT tokens and the modality
    stub: whisper's encoder_seq_len frame embeddings, paligemma's
    num_image_tokens patch embeddings (standard normal, float32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (ENCDEC_BATCH, ENCDEC_PROMPT)).astype(np.int32)
    n = cfg.encoder_seq_len if cfg.is_encoder_decoder \
        else cfg.num_image_tokens
    key = "enc_frames" if cfg.is_encoder_decoder else "image_embeds"
    return toks, {key: torch.from_numpy(rng.standard_normal(
        (ENCDEC_BATCH, n, cfg.d_model)).astype(np.float32)).to(DEVICE)}


def _encdec_launches(cfg):
    """{kernel: launches} of one generate: #1 on every encoder layer, every
    decoder prefill and every cross-attention at prefill and at each of
    the ENCDEC_NEW - 1 decode steps (the last token needs none); #8 on
    every decoder layer and step."""
    L, steps = cfg.num_layers, ENCDEC_NEW - 1
    flash = L
    if cfg.is_encoder_decoder:
        flash += cfg.num_encoder_layers + L + L * steps
    return {"flash_attention": flash, "decode_attention": L * steps}


def phase_encdec(smi):
    """Phase 9 (c): whisper-base (all 6 encoder and 6 decoder layers, 1500
    seeded frame embeddings) and paligemma-3b (all 18 layers, 256 seeded
    image embeddings, vocab 257216) at full width in bf16 through
    ``AsymmetricPipeline.generate(batch_extras=)`` on a 2-stage split:
    ENCDEC_BATCH prompts of ENCDEC_PROMPT tokens, ENCDEC_NEW new tokens.
    #1 and #8 must launch exactly ``_encdec_launches`` times, the prefill's
    logits must be finite and the tokens in the vocabulary. Then both at 2
    layers in fp32 through the kernels and the plain versions: equal
    tokens, prefill logits within ENCDEC_FP32_ATOL. Returns {arch: launch
    counts of the bf16 generate}."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.pipeline import AsymmetricPipeline
    out = {}
    for arch in ENCDEC:
        cfg = _encdec_cfg(arch)
        split = _pipeline_asg(cfg.num_layers).pipelines[0].layer_split
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params = M.init_params(cfg, 0, device=DEVICE)
        pipe = AsymmetricPipeline(cfg, params, split, device=DEVICE)
        toks, extras = _encdec_inputs(cfg)
        logits = pipe.prefill(toks, max_new=ENCDEC_NEW, batch_extras=extras)
        if not np.isfinite(logits).all() \
                or logits.shape != (ENCDEC_BATCH, cfg.vocab_size):
            raise AssertionError(f"{arch}: prefill logits {logits.shape}, "
                                 f"finite {np.isfinite(logits).all()}")
        pipe.generate(toks, max_new=2, batch_extras=extras)    # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = pipe.generate(toks, max_new=ENCDEC_NEW, batch_extras=extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = ops.launch_counts()
        want = _encdec_launches(cfg)
        for k, n in want.items():
            if launched[k] != n:
                raise AssertionError(f"{arch}: {k} launched {launched[k]} "
                                     f"times, the path needs {n}")
        if got.shape != (ENCDEC_BATCH, ENCDEC_NEW) \
                or not ((0 <= got) & (got < cfg.vocab_size)).all():
            raise AssertionError(f"{arch}: tokens {got.shape}")
        extra = next(iter(extras.values()))
        log(f"  {arch} at full width, {cfg.num_layers} layers"
            + (f" + {cfg.num_encoder_layers} encoder" if
               cfg.is_encoder_decoder else "")
            + f", {cfg.dtype}, stages {split}: {ENCDEC_BATCH} prompts of "
            f"{ENCDEC_PROMPT} tokens + {tuple(extra.shape)} stub "
            f"embeddings, {ENCDEC_NEW} new tokens in {wall:.3f} s = "
            f"{got.size / wall:.1f} generated tok/s; launches {launched} "
            f"(as the path needs); peak device memory of the model "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB "
            f"on {smi}")
        out[arch] = launched
        del pipe, params
        torch.cuda.empty_cache()
        # fp32 at 2 layers: the kernels against the plain versions
        cfg = _encdec_cfg(arch, layers=2, dtype="float32")
        params = M.init_params(cfg, 0, device=DEVICE)
        toks, extras = _encdec_inputs(cfg, seed=1)
        res = {}
        for backend in ("kernel", "plain"):
            with ops.backend(backend):
                pipe = AsymmetricPipeline(cfg, params, [1, 1], device=DEVICE)
                res[backend] = (
                    pipe.prefill(toks, max_new=ENCDEC_NEW,
                                 batch_extras=extras),
                    pipe.generate(toks, max_new=ENCDEC_NEW,
                                  batch_extras=extras))
                del pipe
        err = float(np.abs(res["kernel"][0] - res["plain"][0]).max())
        if not err <= ENCDEC_FP32_ATOL:
            raise AssertionError(f"{arch} fp32: prefill logits {err} apart "
                                 f"> {ENCDEC_FP32_ATOL}")
        if not np.array_equal(res["kernel"][1], res["plain"][1]):
            raise AssertionError(f"{arch} fp32: the kernels' tokens differ "
                                 "from the plain versions'")
        log(f"  {arch} fp32, 2 layers: tokens through the kernels == plain "
            f"({res['kernel'][1].shape}); prefill logits max abs diff "
            f"{err:.3g} (<= {ENCDEC_FP32_ATOL})")
        del params
        torch.cuda.empty_cache()
    return out


def cross_cases(gen, dev, dtype, hq=8, hkv=8, d=64):
    """whisper's cross-attention (g 1, d 64): 1 query (a decode step) and
    37 (a ragged prompt) against the encoder's 1500 frames, non-causal;
    and its encoder's 1500 x 1500."""
    from repro_torch.kernels import ops
    k = _rand(gen, (4, 1500, hkv, d), dtype, dev)
    v = _rand(gen, (4, 1500, hkv, d), dtype, dev)
    for sq in (1, 37):
        q = _rand(gen, (4, sq, hq, d), dtype, dev)
        yield f"cross sq={sq} skv=1500", (
            lambda q=q: ops.flash_attention(q, k, v, causal=False)), None
    q = _rand(gen, (2, 1500, hq, d), dtype, dev)
    yield "encoder 1500 x 1500", lambda: ops.flash_attention(
        q, k[:2], v[:2], causal=False), None


# (d): the new instances' cases (rows of the kernels line: name, cases,
# widths)
ENCDEC_CASES = (("flash_attention[d256]", flash_cases,
                 dict(hq=8, hkv=1, d=256)),
                ("flash_attention[cross]", cross_cases, {}),
                ("decode_attention[d256]", contiguous_decode_cases,
                 dict(hq=8, hkv=1, d=256)))


def phase_encdec_kernels(dev):
    """Phase 9 (d): #1 at head dim 256 (paligemma's g 8: causal, the
    window, kv_len and kv_start with dead rows, s = 5, a ragged s of 645,
    g 1), #1 non-causal with sq 1 and 37 against 1500 keys and on the
    1500 x 1500 encoder (whisper's g 1, d 64), and #8 at head dim 256 (g
    8, phase 2's contiguous cases) against their plain versions in bf16
    and fp32; then timed at the serving path's shapes: paligemma's prefill
    (4 rows of 256 image + 32 prompt tokens, causal), whisper's
    cross-attention of a 32-token prompt to 1500 frames, and paligemma's
    decode step at 288..319 cached keys, beside their bound, plain version
    and SDPA. Returns {row: timing dict} as time_kernels does."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(9)
    for row, cases, widths in ENCDEC_CASES:
        name = row.split("[")[0]
        for dtype in (torch.bfloat16, torch.float32):
            for case, fn, dead in cases(gen, dev, dtype, **widths):
                got, want = _run_both(fn)
                torch.cuda.synchronize()
                err = _compare(row, case, got, want, dtype)
                if dead is not None and torch.count_nonzero(dead(got)):
                    raise AssertionError(f"{row} [{case}, {dtype}]: a row "
                                         "that sees no key is not zero")
                log(f"  check {row} [{case}] {dtype} {widths}: max abs err "
                    f"{err:.3g}")
    dt, flush = torch.bfloat16, torch.empty(64 << 20, dtype=torch.uint8,
                                            device=dev)
    res = {}
    q = _rand(gen, (4, 288, 8, 256), dt, dev)
    k, v = (_rand(gen, (4, 288, 1, 256), dt, dev) for _ in range(2))
    res["flash_attention[d256]"] = _flash_timing(dict(q=q, k=k, v=v), flush)
    qc = _rand(gen, (4, 32, 8, 64), dt, dev)
    kc, vc = (_rand(gen, (4, 1500, 8, 64), dt, dev) for _ in range(2))
    res["flash_attention[cross]"] = dict(
        fn=lambda: ops.flash_attention(qc, kc, vc, causal=False),
        nbytes=qc.element_size() * (2 * qc.numel() + kc.numel()
                                    + vc.numel()),
        flops=4 * 64 * 8 * 4 * 32 * 1500,
        library_ms=_time_sdpa(qc, kc, vc, flush))
    qd = _rand(gen, (4, 1, 8, 256), dt, dev)
    kd, vd = (_rand(gen, (4, 320, 1, 256), dt, dev) for _ in range(2))
    kv_len = torch.tensor([288, 300, 311, 319], device=dev)
    kv = int(kv_len.sum())
    mask = (torch.arange(320, device=dev)[None] < kv_len[:, None])[
        :, None, None]
    res["decode_attention[d256]"] = dict(
        fn=lambda: ops.decode_attention(qd, kd, vd, kv_len=kv_len),
        nbytes=dt.itemsize * (2 * qd.numel() + 2 * kv * 256) + 4 * 4,
        flops=4 * 256 * 8 * kv,
        library_ms=_time_sdpa(qd, kd, vd, flush, attn_mask=mask))
    out = {}
    for name, r in res.items():
        got, want = _run_both(r["fn"])
        err = _compare_out(name, "serving shape", got, want, dt)
        ms = _time_ms(r["fn"], flush)
        with ops.backend("plain"):
            plain_ms = _time_ms(r["fn"], flush, iters=3)
        bound_ms, bound_by = _bound(r["nbytes"], r["flops"])
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=r["library_ms"],
                         max_abs_err=err)
        log(f"  time {name}: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}) library "
            f"{r['library_ms']:.4f} ms, bf16 max abs err {err:.3g}")
    return out


# ---------------------------------------------------------------------------
# Phase 10: training (AdamW, the train step) and the backward kernels
# ---------------------------------------------------------------------------

TRAIN_BATCH = (2, 512)            # (a): llama2-70b fp32, 2 layers
TRAIN_JAMBA_BATCH = (2, 300)      # (b): three chunks of the scan, one ragged
TRAIN_JAMBA_STEPS = 3
TRAIN_BF16 = (4, 1024)            # (d): llama2-70b bf16, 4 layers
TRAIN_BF16_LAYERS = 4
TRAIN_BF16_STEPS = 5
TRAIN_BF16_OFF_STEPS = 3          # (d): the same steps without remat
TRAIN_WIDE_LAYERS = 2             # (e): danube and paligemma at full width
# (d): the earlier phases' engines may leave no more than this allocated
# before a garbage collection (F8: 16.76 GiB when they held cycles)
F8_HELD_GIB = 1.0
# (d): the bf16 step's peak before activation checkpointing and the chunked
# AdamW update (NVIDIA H100 80GB HBM3, 700 W); the step must now stay under
PARENT_TRAIN_PEAK_GIB = 61.7
GRAD_RTOL = 1e-4                  # kernels vs plain: of a leaf's largest
LOSS_RTOL = 1e-5
FP32_BWD_RTOL = 5e-5              # (c) fp32 kernel vs twin, of the largest
# (c) the forward's lse against the plain version's: fp32 log-sum-exps of
# O(1) scores over <= 1024 keys differ by ~1e-6 in summation order and
# ex2; a row over the wrong keys or from the wrong Q is off by >= ~1e-3
LSE_ATOL = 1e-4


def _nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def _train_batch(cfg, b, s, seed, step=0):
    """Step `step`'s SyntheticStream batch on the card (the models trained
    here take no modality stubs)."""
    from repro_torch.training.data import DataConfig, SyntheticStream
    data = SyntheticStream(DataConfig(cfg.vocab_size, s, b, seed=seed))
    return {"tokens": torch.as_tensor(data.batch(step)["tokens"],
                                      device=DEVICE)}


def _loss_and_grads(cfg, params, batch):
    """loss_fn's value and a copy of every float leaf's gradient (in
    optimizer.leaves order), the grads left cleared."""
    from repro_torch.models import model as M
    from repro_torch.training import optimizer
    leaves = [p for p in optimizer.leaves(params) if p.is_floating_point()]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = M.loss_fn(cfg, params, batch)
    loss.backward()
    grads = [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    for p in leaves:
        p.grad = None
    return float(loss.detach()), grads


def _gate_grads(what, loss_k, grads_k, loss_p, grads_p):
    """Raise unless the kernels' loss is within LOSS_RTOL of the plain
    versions' and every gradient leaf within GRAD_RTOL of its largest
    magnitude. Returns the worst leaf's error over that magnitude."""
    if not abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"{what}: loss {loss_k} through the kernels, "
                             f"{loss_p} through the plain versions")
    worst = 0.0
    for i, (g, w) in enumerate(zip(grads_k, grads_p)):
        scale = float(w.abs().max())
        err = float((g - w).abs().max()) / max(scale, 1e-30)
        if not (math.isfinite(err) and err <= GRAD_RTOL):
            raise AssertionError(f"{what}: gradient leaf {i} "
                                 f"{tuple(w.shape)}: max err {err:.3g} of "
                                 f"its largest magnitude {scale:.3g}")
        worst = max(worst, err)
    return worst


def phase_train_parity():
    """Phase 10 (a), (b): fp32 train steps through the kernels and through
    the plain versions from the same weights: (a) llama2-70b at full
    width, 2 layers, batch TRAIN_BATCH; (b) jamba-v0.1-52b reduced,
    TRAIN_JAMBA_STEPS steps, each step's gradients held before the
    kernels' update. The backward kernels run in the kernel runs only.
    Returns the kernel runs' launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.training import optimizer
    from repro_torch.training.train_step import make_train_step
    counts = dict.fromkeys(ops.KERNELS, 0)
    opt_cfg = optimizer.AdamWConfig(lr=1e-4, warmup_steps=1,
                                    total_steps=10)
    llama = dataclasses.replace(_llama(2), dtype="float32")
    jamba = get_config("jamba-v0.1-52b").reduced()
    for cfg, (b, s), steps in ((llama, TRAIN_BATCH, 1),
                               (jamba, TRAIN_JAMBA_BATCH,
                                TRAIN_JAMBA_STEPS)):
        params = M.init_params(cfg, 0, device=DEVICE)
        state = optimizer.init(params)
        step_fn = make_train_step(cfg, opt_cfg)
        for step in range(steps):
            batch = _train_batch(cfg, b, s, seed=0, step=step)
            ops.reset_launch_counts()
            loss_k, grads_k = _loss_and_grads(cfg, params, batch)
            launched = ops.launch_counts()
            with ops.backend("plain"):
                loss_p, grads_p = _loss_and_grads(cfg, params, batch)
            if ops.launch_counts() != launched:
                raise AssertionError(f"{cfg.name}: the plain run launched "
                                     f"{ops.launch_counts()} (kernel run "
                                     f"{launched})")
            worst = _gate_grads(f"{cfg.name} step {step}", loss_k, grads_k,
                                loss_p, grads_p)
            del grads_k, grads_p
            # the train step itself (the main path): counted
            ops.reset_launch_counts()
            params, state, loss = step_fn(params, state, batch)
            launched = ops.launch_counts()
            for k, n in launched.items():
                counts[k] += n
            log(f"  train {cfg.name} ({cfg.num_layers} layers, fp32, "
                f"batch {b} x {s}) step {step + 1}: loss {loss_k:.6f} "
                f"kernels, {loss_p:.6f} plain, step's loss {float(loss):.6f}"
                f"; worst gradient leaf {worst:.3g} of its largest "
                f"magnitude (gate {GRAD_RTOL}); step's launches "
                f"{_nonzero(launched)}")
            need = ["flash_attention", "flash_attention_bwd"]
            if MAMBA in (cfg.layer_pattern or ()):
                need += ["ssm_scan", "ssm_scan_bwd"]
            if not all(launched[k] for k in need):
                raise AssertionError(f"{cfg.name}: {need} must all launch: "
                                     f"{launched}")
        del params, state
        torch.cuda.empty_cache()
    return counts


def _bwd_attention_inputs(gen, dev, dtype, b=4, s=1024, hq=64, hkv=8,
                          d=128, causal=True):
    from repro_torch.kernels import flash_attention as fa
    q = _rand(gen, (b, s, hq, d), dtype, dev)
    k = _rand(gen, (b, s, hkv, d), dtype, dev)
    v = _rand(gen, (b, s, hkv, d), dtype, dev)
    do = _rand(gen, (b, s, hq, d), dtype, dev)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    return dict(q=q, k=k, v=v, o=o, lse=lse, do=do, causal=causal)


def _bwd_scan_inputs(gen, dev, b=4, s=1024, din=8192, ds=16,
                     dtype=torch.bfloat16):
    from repro_torch.kernels import ssm_scan as ss
    x = _scan_inputs(gen, dev, b, s, din, ds, dtype)
    _, _, x["h_ins"] = ss.ssm_scan_cuda(x["x"], x["dt"], x["A"], x["B"],
                                        x["C"], x["D"], return_states=True)
    x["dy"] = _rand(gen, (b, s, din), dtype, dev)
    return x


def _check_bwd(name, case, fn, twin, dtype):
    """fn (the kernel) twice, bit for bit, and against twin (the plain
    version) on the same inputs: fp32 within FP32_BWD_RTOL of the largest
    magnitude, bf16 within one bf16 ulp of it (_bf16_tol). Returns the
    worst error over the largest magnitude."""
    got, again = fn(), fn()
    want = twin()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} [{case}, {dtype}]: two runs differ")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        tol = (FP32_BWD_RTOL * scale if dtype == torch.float32
               else _bf16_tol(w))
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"{name} [{case}, {dtype}]: output {i} max "
                                 f"abs err {err} > {tol}")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def _check_scratch_unread(name, case, fn):
    """fn() (a backward kernel's wrapper) once more with every float tensor
    that torch.empty makes during it (its scratch) filled with NaN first:
    each output must equal a run on memory as the allocator hands it out,
    bit for bit, so that no output depends on scratch the kernel did not
    write. Returns the number of tensors poisoned (at least one)."""
    got = fn()
    real, made = torch.empty, []

    def empty(*args, **kwargs):
        t = real(*args, **kwargs)
        if t.is_floating_point():
            made.append(t.fill_(float("nan")))
        return t

    torch.empty = empty
    try:
        poisoned = fn()
    finally:
        torch.empty = real
    torch.cuda.synchronize()
    if not made:
        raise AssertionError(f"{name} [{case}]: no scratch to poison")
    for i, (a, b) in enumerate(zip(got, poisoned)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} [{case}]: output {i} changes when "
                                 "its scratch starts as NaN")
    return len(made)


def _check_train_gqa(gen, dev, dtype, causal, hq, hkv, d, b=2, s=1024,
                     window=0):
    """#1's training forward (return_lse) and backward at a GQA group that
    need not divide the bf16 body's 64-row warpgroups (the zoo's g 48 and
    g 3), at the head dims of h2o-danube-1.8b (80) and paligemma-3b (256),
    and under a sliding window: o and lse, two runs bit for bit, against
    attention_fwd_lse_ref; then the backward fed the plain version's o and
    lse against its twin (_check_bwd) and on NaN scratch
    (_check_scratch_unread)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    case = (f"({b}, {s}, {hq}/{hkv}, {d}) causal={causal}"
            + (f" window={window}" if window else ""))
    mask = dict(causal=causal, window=window)
    q = _rand(gen, (b, s, hq, d), dtype, dev)
    k = _rand(gen, (b, s, hkv, d), dtype, dev)
    v = _rand(gen, (b, s, hkv, d), dtype, dev)
    do = _rand(gen, (b, s, hq, d), dtype, dev)
    got, again = [fa.flash_attention_cuda(q, k, v, return_lse=True, **mask)
                  for _ in range(2)]
    o, lse = ref.attention_fwd_lse_ref(q, k, v, **mask)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention lse [{case}, {dtype}]: two "
                             "runs differ")
    o_err = float((got[0].float() - o.float()).abs().max())
    o_tol = FP32_ATOL if dtype == torch.float32 else _bf16_tol(o)
    lse_err = float((got[1] - lse).abs().max())
    if not (math.isfinite(o_err) and o_err <= o_tol
            and math.isfinite(lse_err) and lse_err <= LSE_ATOL):
        raise AssertionError(f"flash_attention lse [{case}, {dtype}]: o max "
                             f"abs err {o_err} (tol {o_tol}), lse {lse_err} "
                             f"(tol {LSE_ATOL})")
    args = [q, k, v, o, lse, do]
    err = _check_bwd(
        "flash_attention_bwd", case,
        lambda: fa.flash_attention_bwd_cuda(*args, **mask),
        lambda: ref.attention_bwd_ref(*args, **mask), dtype)
    _check_scratch_unread(
        "flash_attention_bwd", f"{case}, {dtype}",
        lambda: fa.flash_attention_bwd_cuda(*args, **mask))
    log(f"  check flash_attention lse + flash_attention_bwd [{case}] "
        f"{dtype}: o max abs err {o_err:.3g}, lse {lse_err:.3g}; backward "
        f"max err {err:.3g} of the largest gradient; two runs of each "
        "bit-identical, the backward's the same on NaN scratch")
    del q, k, v, do, got, again, o, lse, args
    torch.cuda.empty_cache()


# phase 10 (c): #1's training instances at h2o-danube-1.8b's head dim 80
# (g 4), paligemma-3b's 256 (g 8), and under a 256-key window on 1024 keys
# at d 64, 80 and 128
TRAIN_WIDTHS = (dict(hq=32, hkv=8, d=80), dict(hq=8, hkv=1, d=256),
                dict(hq=32, hkv=8, d=64, window=256),
                dict(hq=32, hkv=8, d=80, window=256),
                dict(hq=64, hkv=8, d=128, window=256))


def check_bwd_kernels(dev):
    """Phase 10 (c): #1's backward at llama2-70b's widths (4, 1024, 64 / 8,
    128), causal and not; #1's training forward (o, lse) and backward at
    the zoo's g 48 (d 128) and g 3 (d 64), causal and not, and causal at
    TRAIN_WIDTHS (d 80, d 256, windowed), b 2, s 1024; and #9's at jamba's
    layer width (4, 1024, 8192, 16; x bf16, dt fp32, and all fp32) against
    their plain versions, two runs of each bit for bit; and #1's bf16
    backward against the fp32 plain version of the same inputs (F4: both
    passes round P to bf16)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device=dev).manual_seed(10)
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            x = _bwd_attention_inputs(gen, dev, dtype, causal=causal)
            args = [x[n] for n in ("q", "k", "v", "o", "lse", "do")]
            err = _check_bwd(
                "flash_attention_bwd", f"causal={causal}",
                lambda: fa.flash_attention_bwd_cuda(*args, causal=causal),
                lambda: ref.attention_bwd_ref(*args, causal=causal), dtype)
            log(f"  check flash_attention_bwd [(4, 1024, 64/8, 128) causal="
                f"{causal}] {dtype}: max err {err:.3g} of the largest "
                "gradient; two runs bit-identical")
            if dtype == torch.bfloat16:
                f32 = [t.float() for t in args[:3]] + [args[5].float()]
                o32, lse32 = ref.attention_fwd_lse_ref(*f32[:3],
                                                       causal=causal)
                want = ref.attention_bwd_ref(*f32[:3], o32, lse32, f32[3],
                                             causal=causal)
                got = fa.flash_attention_bwd_cuda(*args, causal=causal)
                errs = [float((g.float() - w).abs().max()
                              / w.abs().max()) for g, w in zip(got, want)]
                log(f"  F4: bf16 flash_attention_bwd (causal={causal}) "
                    "against the fp32 plain version of the same inputs: "
                    "dq, dk, dv max err " + ", ".join(f"{e:.3g}"
                                                      for e in errs)
                    + " of the largest gradient")
                del f32, o32, lse32, want, got
            del x, args
            torch.cuda.empty_cache()
    for w in ZOO_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                _check_train_gqa(gen, dev, dtype, causal, **w)
    # the widths and masks that h2o-danube-1.8b (d 80, a window) and
    # paligemma-3b (d 256) train with (TRAIN_WIDTHS)
    for w in TRAIN_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            _check_train_gqa(gen, dev, dtype, True, **w)
    for dtype in (torch.bfloat16, torch.float32):
        x = _bwd_scan_inputs(gen, dev, dtype=dtype)
        args = [x[n] for n in ("x", "dt", "A", "B", "C", "D", "h_ins", "dy")]
        err = _check_bwd("ssm_scan_bwd", "dh_out 0",
                         lambda: ss.ssm_scan_bwd_cuda(*args),
                         lambda: ref.ssm_scan_bwd_ref(*args), dtype)
        log(f"  check ssm_scan_bwd [(4, 1024, 8192, 16), dt fp32] {dtype}: "
            f"max err {err:.3g} of the largest gradient; two runs "
            "bit-identical")
        del x, args
    torch.cuda.empty_cache()


# phase 10 (c): the tensor-core backward's edges (bf16 at d 128 with g 8
# and d 64 with g 3): s = 1000 (no multiple of a 64-row tile or a
# 128-key block), causal and not; live keys from kv_len / kv_start; sq !=
# skv both ways; a window on sq < skv
BWD_EDGES = (dict(b=2, sq=1000, skv=1000, causal=True),
             dict(b=2, sq=1000, skv=1000, causal=False),
             dict(b=3, sq=384, skv=640, causal=True, kv_len=(640, 500, 333),
                  kv_start=(0, 37, 129)),
             dict(b=2, sq=640, skv=384, causal=False, kv_len=(384, 200),
                  kv_start=(5, 0)),
             dict(b=2, sq=300, skv=1000, causal=True, window=128))
BWD_EDGE_WIDTHS = (dict(hq=64, hkv=8, d=128), dict(hq=24, hkv=8, d=64))
# ... and #9's backward at (2, s, din, ds), dh_out given: three chunks, the
# last ragged, at d_state 4, 8 and 16; din 1000 (a block's last 64
# channels part dead, rows still 16-byte aligned); din 1001 at s 301 (no
# row of x, dt or dy aligned, nor row 1 of B and C in bf16 at d_state 4:
# the element-wise loads)
SCAN_BWD_EDGES = ((300, 1024, 4), (300, 1024, 8), (300, 1024, 16),
                  (300, 1000, 16), (301, 1001, 4))


def check_bwd_edges(dev):
    """Phase 10 (c): #1's backward at BWD_EDGES x BWD_EDGE_WIDTHS in bf16
    (the tensor-core body), fed its forward's o and lse under the same
    mask, and #9's at SCAN_BWD_EDGES with dh_out, x bf16 and fp32 (dt
    fp32): two runs bit for bit and each gradient against the plain
    version (_check_bwd), and the same bits on NaN scratch
    (_check_scratch_unread)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device=dev).manual_seed(12)
    dtype = torch.bfloat16
    for w in BWD_EDGE_WIDTHS:
        for e in BWD_EDGES:
            b, sq, skv = e["b"], e["sq"], e["skv"]
            mask = dict(causal=e["causal"], window=e.get("window", 0))
            for name in ("kv_len", "kv_start"):
                if name in e:
                    mask[name] = torch.tensor(e[name], dtype=torch.int32,
                                              device=dev)
            q = _rand(gen, (b, sq, w["hq"], w["d"]), dtype, dev)
            k = _rand(gen, (b, skv, w["hkv"], w["d"]), dtype, dev)
            v = _rand(gen, (b, skv, w["hkv"], w["d"]), dtype, dev)
            do = _rand(gen, (b, sq, w["hq"], w["d"]), dtype, dev)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                             **mask)
            args = [q, k, v, o, lse, do]
            case = (f"({b}, {sq}/{skv}, {w['hq']}/{w['hkv']}, {w['d']}) "
                    + " ".join(f"{n}={e[n]}" for n in
                               ("causal", "window", "kv_len", "kv_start")
                               if n in e))
            err = _check_bwd(
                "flash_attention_bwd", case,
                lambda: fa.flash_attention_bwd_cuda(*args, **mask),
                lambda: ref.attention_bwd_ref(*args, **mask), dtype)
            _check_scratch_unread(
                "flash_attention_bwd", case,
                lambda: fa.flash_attention_bwd_cuda(*args, **mask))
            log(f"  check flash_attention_bwd [{case}] {dtype}: max err "
                f"{err:.3g} of the largest gradient; two runs bit-identical, "
                "the same on NaN scratch")
            del q, k, v, do, o, lse, args
    for s, din, ds in SCAN_BWD_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            x = _bwd_scan_inputs(gen, dev, b=2, s=s, din=din, ds=ds,
                                 dtype=dtype)
            x["dh_out"] = torch.randn((2, din, ds), generator=gen,
                                      device=dev)
            args = [x[n] for n in ("x", "dt", "A", "B", "C", "D", "h_ins",
                                   "dy", "dh_out")]
            case = f"(2, {s}, {din}, {ds}), dh_out"
            err = _check_bwd("ssm_scan_bwd", case,
                             lambda: ss.ssm_scan_bwd_cuda(*args),
                             lambda: ref.ssm_scan_bwd_ref(*args), dtype)
            _check_scratch_unread(
                "ssm_scan_bwd", f"{case}, {dtype}",
                lambda: ss.ssm_scan_bwd_cuda(*args))
            log(f"  check ssm_scan_bwd [(2, {s}, {din}, {ds}), dt fp32, "
                f"dh_out] {dtype}: max err {err:.3g} of the largest "
                "gradient; two runs bit-identical, the same on NaN scratch")
            del x, args
    torch.cuda.empty_cache()


# phase 10 (c)'s timing shapes of #1's training instances beyond llama's,
# in the instances phase 10 (e) launches (fp32): h2o-danube-1.8b's widths
# (d 80, g 4) and paligemma-3b's (d 256, g 8), as its full-width runs train
# them, and reduced h2o-danube-1.8b's windowed d 64 at danube's heads under
# a 256-key window; b 4, s 1024, causal
TRAIN_TIMING = {"d80": dict(hq=32, hkv=8, d=80),
                "d256": dict(hq=8, hkv=1, d=256),
                "window": dict(hq=32, hkv=8, d=64, window=256)}


def _time_train_attention(gen, dev, flush, tag, hq, hkv, d, window=0,
                          b=4, s=1024, dt=torch.float32):
    """#1's training forward (return_lse) and its backward at (b, s, hq /
    hkv, d), causal, under `window`, in `dt`: rows
    "flash_attention[lse-<tag>]" and "flash_attention_bwd[<tag>]" with
    their plain versions' times, bounds (the forward's two products and
    the backward's five over the pairs the mask keeps, at the peak rate of
    the body dt runs on; or their bytes) and SDPA's forward and backward
    on the same inputs and mask (the library yardstick; the port never
    calls it)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    mask = dict(causal=True, window=window)
    q = _rand(gen, (b, s, hq, d), dt, dev)
    k = _rand(gen, (b, s, hkv, d), dt, dev)
    v = _rand(gen, (b, s, hkv, d), dt, dev)
    do = _rand(gen, (b, s, hq, d), dt, dev)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **mask)
    args = [q, k, v, o, lse, do]
    pairs = b * sum(min(p + 1, window or s) for p in range(s))
    es = q.element_size()
    pos = torch.arange(s, device=dev)
    allowed = pos[None, :] <= pos[:, None]
    if window:
        allowed &= pos[None, :] > pos[:, None] - window
    qt, kt, vt, gqa = _sdpa_inputs(q, k, v)
    sdpa = dict(attn_mask=allowed) if window else dict(is_causal=True)
    qt, kt, vt = (t.requires_grad_(True) for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa, **gqa)
    dot = do.transpose(1, 2).contiguous()
    rows = {}
    fwd = lambda: fa.flash_attention_cuda(q, k, v, return_lse=True,  # noqa
                                          **mask)
    plain_fwd = lambda: ref.attention_fwd_lse_ref(q, k, v, **mask)  # noqa
    got, want = fwd(), plain_fwd()
    rate = _rate(q)["flop_rate"]
    bound_ms, bound_by = _bound(
        es * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel(),
        2 * 2 * d * hq * pairs, rate)
    with torch.no_grad():
        lib = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa, **gqa), flush)
    rows[f"flash_attention[lse-{tag}]"] = dict(
        ms=_time_ms(fwd, flush), plain_ms=_time_ms(plain_fwd, flush,
                                                   iters=3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
        max_abs_err=float((got[0].float() - want[0].float()).abs().max()))
    del got, want
    bwd = lambda: fa.flash_attention_bwd_cuda(*args, **mask)  # noqa
    plain_bwd = lambda: ref.attention_bwd_ref(*args, **mask)  # noqa
    bound_ms, bound_by = _bound(
        es * (5 * q.numel() + 4 * k.numel()) + 4 * lse.numel(),
        5 * 2 * d * hq * pairs, rate)
    rows[f"flash_attention_bwd[{tag}]"] = dict(
        ms=_time_ms(bwd, flush), plain_ms=_time_ms(plain_bwd, flush,
                                                   iters=3),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), flush),
        max_abs_err=float(max((g.float() - w.float()).abs().max()
                              for g, w in zip(bwd(), plain_bwd()))))
    del q, k, v, do, o, lse, args, qt, kt, vt, out, dot, allowed
    torch.cuda.empty_cache()
    return rows


def time_bwd_kernels(dev):
    """Phase 10 (c): the backward kernels timed at the training path's
    shapes (CUDA events after an L2 flush), with their plain versions,
    bounds, and SDPA's backward for #1 (the library yardstick; the port
    never calls it). #1's bound: its five products over the causal pairs
    at the peak rate of its dtype's body (bf16 at llama's widths, fp32 at
    TRAIN_TIMING's), or its bytes (q, k, v, o, dO, lse read, dq,
    dk, dv written); #9's: one exponential a state element and step on
    the SFUs (a[t]; the kernel evaluates three), or its bytes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # #1's backward at llama2-70b's widths (its row of the kernels line),
    # then at TRAIN_TIMING's with #1's training forward beside it
    res = {"flash_attention_bwd": _time_train_attention(
        gen, dev, flush, "llama", hq=64, hkv=8, d=128, dt=torch.bfloat16)[
            "flash_attention_bwd[llama]"]}
    for tag, shape in TRAIN_TIMING.items():
        res.update(_time_train_attention(gen, dev, flush, tag, **shape))
    x = _bwd_scan_inputs(gen, dev)
    args = [x[n] for n in ("x", "dt", "A", "B", "C", "D", "h_ins", "dy")]
    b, s, din = x["x"].shape
    ds = x["A"].shape[1]
    n = b * s * din * ds
    es = x["x"].element_size()
    nbytes = (es * 3 * b * s * din          # x, dy read, dx written
              + 4 * 2 * b * s * din         # dt (fp32) read, ddt written
              + es * 4 * b * s * ds         # B, C read, dB, dC written
              + 4 * (x["h_ins"].numel() + 2 * din * ds + 2 * din
                     + b * din * ds))       # h_ins, A, dA, D, dD, dh0
    bound_ms, bound_by = _bound(nbytes, 2 * 7 * n, FP32_FLOP_PER_S, exps=n)
    res["ssm_scan_bwd"] = dict(
        ms=_time_ms(lambda: ss.ssm_scan_bwd_cuda(*args), flush),
        plain_ms=_time_ms(lambda: ref.ssm_scan_bwd_ref(*args), flush,
                          iters=2),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        max_abs_err=float(max((g.float() - w.float()).abs().max() for g, w in
                              zip(ss.ssm_scan_bwd_cuda(*args),
                                  ref.ssm_scan_bwd_ref(*args)))))
    del x, args
    torch.cuda.empty_cache()
    for name, r in res.items():
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else "none")
        log(f"  time {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{lib}, max abs err {r['max_abs_err']:.3g}")
    return res


def phase_train_bf16(smi):
    """Phase 10 (d): llama2-70b at full width, TRAIN_BF16_LAYERS layers,
    bf16, batch TRAIN_BF16. First the memory the earlier phases' engines
    left: it must be under F8_HELD_GIB before any garbage collection (the
    engines hold no reference cycles). Then, with REMAT_TRAIN on and off
    from the same weights and batch, the memory the forward keeps for the
    backward pass (less with it on) and one step's loss and gradients,
    bit for bit; TRAIN_BF16_STEPS train steps through the kernels with
    REMAT_TRAIN
    on (AdamW in place, a chunk of a leaf at a time; fp32 moments; a new
    batch of the stream each step), and TRAIN_BF16_OFF_STEPS with it off:
    each step's device time (CUDA events), tokens/s and each setting's
    peak memory, no higher with it on, and the first step's loss beside
    the plain versions' bf16 loss of the same weights and batch; then one
    more step profiled. Returns the timed steps' launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.training import optimizer
    from repro_torch.training.train_step import make_train_step
    cfg = _llama(TRAIN_BF16_LAYERS)
    b, s = TRAIN_BF16
    log(f"phase 10 (d): {cfg.name} at full width, {cfg.num_layers} of 80 "
        f"layers, bf16, batch {b} x {s}, {TRAIN_BF16_STEPS} train steps "
        f"through the kernels ({smi})")
    # F8: the earlier phases' engines are gone, and with them their pools
    # and weights, without a full garbage collection
    held = torch.cuda.memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  device memory held before the weights: {held:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB after a full "
        "garbage collection")
    if held >= F8_HELD_GIB:
        raise AssertionError(f"the earlier phases left {held:.2f} GiB "
                             "allocated until a garbage collection")
    params = M.init_params(cfg, 0, device=DEVICE)
    n_params = sum(p.numel() for p in optimizer.leaves(params))
    with torch.no_grad(), ops.backend("plain"):
        plain_loss = float(M.loss_fn(cfg, params,
                                     _train_batch(cfg, b, s, seed=1)))
    # what the forward keeps for the backward pass, and one step's
    # gradients, with and without activation checkpointing
    batch = _train_batch(cfg, b, s, seed=1)
    for p in optimizer.leaves(params):
        p.requires_grad_(True)
    kept, grads = {}, {}
    for remat in (True, False):
        M.REMAT_TRAIN = remat
        base = torch.cuda.memory_allocated()
        loss = M.loss_fn(cfg, params, batch)
        kept[remat] = (torch.cuda.memory_allocated() - base) / 2 ** 30
        del loss
        grads[remat] = _loss_and_grads(cfg, params, batch)
    M.REMAT_TRAIN = True
    (loss_on, g_on), (loss_off, g_off) = grads[True], grads[False]
    same = loss_on == loss_off and all(torch.equal(x, y)
                                       for x, y in zip(g_on, g_off))
    log(f"  train {cfg.name} bf16 one step's loss and {len(g_on)} gradient "
        f"leaves with REMAT_TRAIN on and off: "
        f"{'bit-identical' if same else 'DIFFERENT'} (loss {loss_on:.6f}); "
        f"the forward keeps {kept[True]:.2f} GiB for the backward pass on, "
        f"{kept[False]:.2f} GiB off")
    if not same:
        raise AssertionError("REMAT_TRAIN changed the gradients")
    if not kept[True] < kept[False]:
        raise AssertionError(f"the forward keeps {kept[True]:.2f} GiB with "
                             f"REMAT_TRAIN, {kept[False]:.2f} GiB without")
    del grads, g_on, g_off
    torch.cuda.empty_cache()
    state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer.AdamWConfig(
        lr=1e-4, warmup_steps=1, total_steps=TRAIN_BF16_STEPS
        + TRAIN_BF16_OFF_STEPS + 1))
    runs = {}
    for remat, steps in ((True, TRAIN_BF16_STEPS),
                         (False, TRAIN_BF16_OFF_STEPS)):
        M.REMAT_TRAIN = remat
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, times = [], []
        for step in range(steps):
            batch = _train_batch(cfg, b, s, seed=1, step=step)
            a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            params, state, loss = step_fn(params, state, batch)
            e.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(e))
            losses.append(float(loss))
        runs[remat] = dict(losses=losses, times=times,
                           launched=ops.launch_counts(),
                           peak=torch.cuda.max_memory_allocated() / 2 ** 30)
    M.REMAT_TRAIN = True
    # one more step under torch.profiler: where the step's time goes
    from torch.profiler import ProfilerActivity, profile
    batch = _train_batch(cfg, b, s, seed=1, step=TRAIN_BF16_STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _log_profile(f"train {cfg.name} bf16 step", prof, wall)
    on = runs[True]
    losses, launched = on["losses"], on["launched"]
    if not all(math.isfinite(x) for r in runs.values()
               for x in r["losses"]):
        raise AssertionError(f"bf16 train losses {runs}")
    if not abs(losses[0] - plain_loss) <= 0.02 * abs(plain_loss):
        raise AssertionError(f"bf16 step 1 loss {losses[0]} through the "
                             f"kernels, {plain_loss} plain")
    for remat, r in runs.items():
        # under REMAT_TRAIN the backward recomputes each layer's #1
        need = len(r["times"]) * cfg.num_layers
        if r["launched"]["flash_attention_bwd"] != need or \
                r["launched"]["flash_attention"] != need * (1 + remat):
            raise AssertionError(f"bf16 training (REMAT_TRAIN {remat}) "
                                 f"launched {r['launched']}, expected "
                                 f"{need * (1 + remat)} of #1 and {need} of "
                                 "its backward")
        steady = r["times"][1:] or r["times"]
        mean = sum(steady) / len(steady)
        log(f"  train {cfg.name} bf16, REMAT_TRAIN {remat}: "
            f"{n_params / 1e9:.3f}e9 parameters; step ms "
            + ", ".join(f"{t:.1f}" for t in r["times"])
            + f" (steady mean {mean:.1f} ms, {b * s / mean * 1e3:.0f} "
            f"tokens/s); peak memory {r['peak']:.1f} GiB; losses "
            + ", ".join(f"{x:.4f}" for x in r["losses"])
            + f"; launches {_nonzero(r['launched'])}")
    if not on["peak"] < PARENT_TRAIN_PEAK_GIB:
        raise AssertionError(f"peak memory {on['peak']:.1f} GiB with "
                             "REMAT_TRAIN, not under the "
                             f"{PARENT_TRAIN_PEAK_GIB} GiB of the step "
                             "without checkpointing and chunked AdamW")
    log(f"  train {cfg.name} bf16: step 1 loss {losses[0]:.5f} kernels vs "
        f"{plain_loss:.5f} plain bf16 forward")
    del params, state
    torch.cuda.empty_cache()
    counts = dict.fromkeys(ops.KERNELS, 0)
    for r in runs.values():
        for k, n in r["launched"].items():
            counts[k] += n
    return counts


def phase_train_archs():
    """Phase 10 (e): the training launcher's entry point,
    ``repro_torch.launch.train.main(["--arch", a, "--reduced", "--steps",
    "2"])``, on the card for every registered architecture (reduced
    h2o-danube-1.8b trains its 64-key window under --seq 128, through the
    windowed backward), and ``python -m repro_torch.launch.train`` once in
    a subprocess; then h2o-danube-1.8b (d 80) and paligemma-3b (d 256) at
    full width, TRAIN_WIDE_LAYERS layers, fp32: the loss within LOSS_RTOL
    and every gradient leaf within GRAD_RTOL of its largest magnitude
    through the kernels against the plain versions. Returns {tag: the
    kernel runs' launches}: "window" (reduced danube), "d80", "d256" (the
    full-width runs), "all" (everything)."""
    import io
    from repro_torch.configs import get_config, list_archs
    from repro_torch.configs.base import ATTN, MAMBA
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import model as M
    by_tag = {t: dict.fromkeys(ops.KERNELS, 0)
              for t in ("window", "d80", "d256", "all")}

    def add(tag, launched):
        for t in {tag, "all"}:
            for k, n in launched.items():
                by_tag[t][k] += n

    for arch in list_archs():
        cfg = get_config(arch).reduced()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            losses = train.main(["--arch", arch, "--reduced", "--steps",
                                 "2"])
        launched = ops.launch_counts()
        add("window" if arch == DANUBE else "all", launched)
        kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
        need = (["flash_attention", "flash_attention_bwd"] * (ATTN in kinds)
                + ["ssm_scan", "ssm_scan_bwd"] * (MAMBA in kinds))
        if len(losses) != 2 or not all(map(math.isfinite, losses)) or \
                not all(launched[k] for k in need):
            raise AssertionError(f"launch.train --arch {arch}: losses "
                                 f"{losses}, launches {launched}, output "
                                 f"{out.getvalue()[-500:]}")
        log(f"  launch.train --arch {arch} --reduced --steps 2: losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; launches {_nonzero(launched)}")
    root = os.path.dirname(os.path.abspath(__file__))
    argv = ["--arch", DANUBE, "--reduced", "--steps", "2"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv, cwd=root,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"python -m repro_torch.launch.train exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    log(f"  cli: python -m repro_torch.launch.train {' '.join(argv)} "
        f"exited 0 on the card: {out.stdout.splitlines()[-1]}")
    b, s = TRAIN_BATCH
    for arch, tag in ((DANUBE, "d80"), ("paligemma-3b", "d256")):
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=TRAIN_WIDE_LAYERS,
                                  dtype="float32")
        params = M.init_params(cfg, 0, device=DEVICE)
        batch = _train_batch(cfg, b, s, seed=0)
        if cfg.num_image_tokens:
            batch["image_embeds"] = 0.1 * torch.randn(
                (b, cfg.num_image_tokens, cfg.d_model),
                generator=torch.Generator(device=DEVICE).manual_seed(0),
                device=DEVICE)
        ops.reset_launch_counts()
        loss_k, grads_k = _loss_and_grads(cfg, params, batch)
        launched = ops.launch_counts()
        with ops.backend("plain"):
            loss_p, grads_p = _loss_and_grads(cfg, params, batch)
        worst = _gate_grads(f"{arch} full width", loss_k, grads_k, loss_p,
                            grads_p)
        add(tag, launched)
        if not (launched["flash_attention"]
                and launched["flash_attention_bwd"]):
            raise AssertionError(f"{arch}: launches {launched}")
        log(f"  train {arch} at full width ({cfg.num_layers} layers, fp32, "
            f"head dim {cfg.head_dim_}, {cfg.num_heads}/{cfg.num_kv_heads} "
            f"heads, batch {b} x {s}): loss {loss_k:.6f} kernels, "
            f"{loss_p:.6f} plain; worst gradient leaf {worst:.3g} of its "
            f"largest magnitude (gate {GRAD_RTOL}); launches "
            f"{_nonzero(launched)}")
        del params, grads_k, grads_p
        torch.cuda.empty_cache()
    return by_tag


def dump_sass(tree, out):
    """Build the kernel sources of another checkout `tree` (a `git archive`
    of the parent commit) with this tree's flags and write each library's
    SASS digests (sass_functions, kernel names as this tree's tools spell
    them) and the nvcc release to `out`: the content of PARENT_SASS's
    "digests" and "nvcc"."""
    from repro_torch.kernels import build
    from pathlib import Path
    csrc = Path(tree) / "src" / "repro_torch" / "csrc"
    libs = build.build([n for n in build.SOURCES
                        if (csrc / f"{n}.cu").exists()],
                       csrc=csrc, build_dir=build.BUILD_DIR / "parent")
    digests = {lib: {name: digest for name, (_, digest) in
                     sorted(sass_functions(so).items())}
               for lib, so in libs.items()}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"nvcc": _nvcc_release(), "digests": digests}, f, indent=1)
    log(f"sass of {tree}: " + ", ".join(f"{lib} {len(d)} kernels" for lib, d
                                        in digests.items()) + f" -> {out}")


def main():
    if sys.argv[1:2] == ["--sass-of"]:         # --sass-of TREE OUT.json
        return dump_sass(*sys.argv[2:4])
    done = mark
    smi = phase_device_and_build()
    done("phase 1")
    log("phase 2: kernels against their plain versions")
    check_kernels(torch.device("cuda"))
    check_mixed_widths(torch.device("cuda"))
    check_scan(torch.device("cuda"))
    timed = time_kernels(torch.device("cuda"))
    done("phase 2")
    counts = phase_serving(smi)
    done("phase 3 (llama)")
    for k, n in phase_jamba(smi).items():
        counts[k] += n
    done("phase 3 (jamba)")
    log("phase 4: engine parity through kernels and plain versions, fp32")
    mixed = {"bf16-pool": phase_parity()}
    phase_parity_jamba()
    phase_parity_zoo()
    mixed["fp32-pool"] = phase_fp32_pool(smi)
    for by in mixed.values():
        for k, n in by.items():
            counts[k] += n
    done("phase 4")
    for k, n in phase_schedule_serve(smi).items():
        counts[k] += n
    done("phase 5")
    danube, d80 = phase_danube(smi)
    done("phase 6")
    zoo, by_tag = phase_zoo(smi)
    done("phase 7")
    phase_multi_parity()
    done("phase 8 (a)")
    multi = phase_multi(smi)
    done("phase 8")
    log("phase 9: online rescheduling; whisper-base and paligemma-3b")
    phase_chaos_parity()
    done("phase 9 (a)")
    chaos = phase_chaos(smi)
    done("phase 9 (b)")
    encdec = phase_encdec(smi)
    done("phase 9 (c)")
    timed.update(phase_encdec_kernels(torch.device("cuda")))
    done("phase 9")
    log("phase 10: training through the backward kernels")
    train = phase_train_parity()
    done("phase 10 (a), (b)")
    check_bwd_kernels(torch.device("cuda"))
    check_bwd_edges(torch.device("cuda"))
    timed.update(time_bwd_kernels(torch.device("cuda")))
    done("phase 10 (c)")
    for k, n in phase_train_bf16(smi).items():
        train[k] += n
    done("phase 10 (d)")
    wide = phase_train_archs()
    for k, n in wide["all"].items():
        train[k] += n
    done("phase 10")
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces,
                            launches=(counts[name] + danube[name]
                                      + zoo[name] + multi[name]
                                      + chaos[name] + train[name]
                                      + sum(encdec[a].get(name, 0)
                                            for a in ENCDEC)),
                            **timed[name]))
    # #1 and #8 at h2o-danube-1.8b's head dim 80: the long-prompt serve's
    # launches (also in the rows above) and the times at its shapes
    for name in D80:
        src, replaces = KERNEL_INFO[name]
        kernels.append(dict(name=f"{name}[d80]", route="cuda", source=src,
                            replaces=replaces, launches=d80[name],
                            **timed[f"{name}[d80]"]))
    # the zoo's g 48 (granite-20b) and g 3 (granite-moe-3b): phase 7's
    # serves of that model (also in the rows above) and the times at its
    # shapes
    for name, tag in ZOO_ROWS:
        src, replaces = KERNEL_INFO[name]
        kernels.append(dict(name=f"{name}[{tag}]", route="cuda", source=src,
                            replaces=replaces, launches=by_tag[tag][name],
                            **timed[f"{name}[{tag}]"]))
    # this slice's instances: #1 at paligemma-3b's head dim 256 and on
    # whisper-base's cross-attention shapes, #8 at head dim 256, with
    # phase 9 (c)'s bf16 launches (also in the rows above: paligemma's
    # #1 and #8, and whisper's #1: encoder, decoder prefill and
    # cross-attention) and the times at their shapes
    for row, arch in (("flash_attention[d256]", "paligemma-3b"),
                      ("flash_attention[cross]", "whisper-base"),
                      ("decode_attention[d256]", "paligemma-3b")):
        name = row.split("[")[0]
        src, replaces = KERNEL_INFO[name]
        kernels.append(dict(name=row, route="cuda", source=src,
                            replaces=replaces, launches=encdec[arch][name],
                            **timed[row]))
    # K2: #2, #3 and #4 on pools of the other width, with phase 4's serves
    # on them (fp32 llama on bf16 pools through the kernels, bf16 llama on
    # fp32 pools; also in the rows above) and the times at phase 3's shapes
    for name in PAGED:
        src, replaces = KERNEL_INFO[name]
        for tag, by in mixed.items():
            kernels.append(dict(name=f"{name}[{tag}]", route="cuda",
                                source=src, replaces=replaces,
                                launches=by[name],
                                **timed[f"{name}[{tag}]"]))
    # #1's training instances and its backward in fp32 at
    # h2o-danube-1.8b's d 80 and paligemma-3b's d 256 (phase 10 (e)'s
    # full-width runs' launches) and at d 64 under a window (reduced
    # danube's 64-key window under launch.train), also in the rows above,
    # and the times of the same instances at TRAIN_TIMING
    for tag in TRAIN_TIMING:
        for name, row in (("flash_attention", f"flash_attention[lse-{tag}]"),
                          ("flash_attention_bwd",
                           f"flash_attention_bwd[{tag}]")):
            src, replaces = KERNEL_INFO[name]
            kernels.append(dict(name=row, route="cuda", source=src,
                                replaces=replaces, launches=wide[tag][name],
                                **timed[row]))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - _T0:.1f} s"
        ", the build included")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
