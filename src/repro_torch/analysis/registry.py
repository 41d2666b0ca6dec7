"""The port's kernel registry: kernel -> oracle -> checks -> cost.

Every hand-written CUDA kernel of the port (a top-level ``*_cuda``
wrapper in one of ``KERNEL_MODULES``) is registered here with:

  * ``op``         -- its name in ``kernels.ops.KERNELS`` (launch counts);
  * ``oracle``     -- its plain PyTorch twin in ``kernels/ref.py``, which
    the wrapper is held against on the card and which a CPU tensor runs;
  * ``ports``      -- the function of the JAX package it replaces: one of
    the nine ``*_pallas`` kernels, or the custom VJPs ``_fa_full_bwd`` /
    ``_ssm_chunks_bwd`` of ``repro/kernels/ops.py``;
  * ``chip_check`` -- the function of ``chip_smoke.py`` that holds it
    against its twin on the card;
  * ``cpu_test``   -- the ``tests/test_torch_*.py`` file that holds the
    twin against the reference on the CPU;
  * ``cost``       -- the work of the op itself, whatever implements it:
    ``{"flops", "bytes", "exps", "dtype"}``. FLOPs count the products (2
    a multiply-add) over the (query, key) pairs the masks keep, so causal
    attention counts only the pairs it attends to; bytes count each input
    read once and each output written once; ``exps`` the exponentials;
    ``dtype`` the type whose peak rate does the work ("fp32" for the
    scalar bodies and the scan, else q's dtype).

``call_cost(op, arguments)`` gives the cost of one call of a
``kernels.ops`` entry point from its bound arguments. It reads shapes and
dtypes only, never a tensor's values: a length argument (``kv_len``,
``kv_start``, ``q_start``) that is a tensor counts as absent, so a decode
counts its whole cache and a chunk every key of its table. The meta
device (which has no values) and the card then count the same work.
Passing the lengths as Python lists counts what they keep
(``chip_smoke.py``'s timing rows).

``check_registry`` validates the table against the tree: the port's copy
of the reference's ``repro.analysis.registry.check_registry``.
"""
from __future__ import annotations

import ast
import collections
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# repo-relative module paths the kernel scan covers
KERNEL_MODULES = (
    "src/repro_torch/kernels/flash_attention.py",
    "src/repro_torch/kernels/decode_attention.py",
    "src/repro_torch/kernels/paged_attention.py",
    "src/repro_torch/kernels/ssm_scan.py",
)
ORACLE_MODULE = "src/repro_torch/kernels/ref.py"
CHIP_SMOKE = "chip_smoke.py"
REFERENCE_OPS = "src/repro/kernels/ops.py"

# the scalar (fp32) bodies and the scan run outside the tensor cores
_DTYPE_NAMES = {"torch.float32": "fp32", "torch.bfloat16": "bf16",
                "torch.float16": "fp16"}


def _dtype_name(t) -> str:
    return _DTYPE_NAMES.get(str(t.dtype), str(t.dtype).replace("torch.", ""))


def _es(t) -> int:
    return t.element_size()


def _numel(t) -> int:
    n = 1
    for s in t.shape:
        n *= int(s)
    return n


def _lens(x, b: int):
    """A length argument as a list of b ints, or None when it is absent or
    a tensor (whose values the cost never reads)."""
    if x is None or hasattr(x, "device"):
        return None
    vals = [int(v) for v in x]
    if len(vals) != b:
        raise ValueError(f"{len(vals)} lengths for {b} rows")
    return vals


def attention_pairs(b: int, sq: int, skv: int, *, causal: bool,
                    window: int = 0, q_start=None, kv_start=None,
                    kv_len=None) -> int:
    """(query, key) pairs that attention's masks keep: row i's query j at
    position q_start[i] + j (0 when absent) sees key p where p <= its
    position (causal), p > its position - window (window > 0),
    kv_start[i] <= p < kv_len[i] (when given) and p < skv."""
    rows = collections.Counter(
        (0 if q_start is None else q_start[i],
         0 if kv_start is None else kv_start[i],
         skv if kv_len is None else min(skv, kv_len[i])) for i in range(b))
    total = 0
    for (qs, ks, cap), n in rows.items():
        t = np.arange(qs, qs + sq, dtype=np.int64)
        hi = np.minimum(t + 1, cap) if causal else np.full_like(t, cap)
        lo = np.maximum(ks, t - window + 1) if window else np.full_like(t, ks)
        total += n * int(np.maximum(hi - lo, 0).sum())
    return total


# ---------------------------------------------------------------------------
# Cost formulas (work of the op, independent of the implementation)
# ---------------------------------------------------------------------------

def flash_attention_cost(*, b, sq, skv, hq, hkv, d, es, dtype, causal=True,
                         window=0, kv_start=None, kv_len=None, lse=False):
    """#1: two products (S = Q K^T, O = P V) over the kept pairs, one
    exponential a pair; q, k, v read, o (and for training the rows' fp32
    log-sum-exp) written."""
    pairs = attention_pairs(b, sq, skv, causal=causal, window=window,
                            kv_start=kv_start, kv_len=kv_len)
    nbytes = es * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
    if lse:
        nbytes += 4 * b * hq * sq
    return dict(flops=4 * d * hq * pairs, bytes=nbytes, exps=hq * pairs,
                dtype=dtype)


def flash_attention_bwd_cost(*, b, sq, skv, hq, hkv, d, es, dtype,
                             causal=True, window=0, kv_start=None,
                             kv_len=None):
    """#1's backward (FA2): five products over the kept pairs (S again,
    dP = dO V^T, dV += P^T dO, dQ = dS K, dK = dS^T Q), one exponential a
    pair; q, k, v, o, dO and lse read, dq, dk, dv written."""
    pairs = attention_pairs(b, sq, skv, causal=causal, window=window,
                            kv_start=kv_start, kv_len=kv_len)
    nbytes = (es * (4 * b * sq * hq * d + 4 * b * skv * hkv * d)
              + 4 * b * hq * sq)
    return dict(flops=5 * 2 * d * hq * pairs, bytes=nbytes,
                exps=hq * pairs, dtype=dtype)


def decode_attention_cost(*, b, S, hq, hkv, d, es, dtype, kv_len=None):
    """#8: one query a row against its kv_len keys (all S when not
    given): two products a key, q read, o written, the keys' K and V
    read, the lengths read."""
    keys = b * S if kv_len is None else sum(min(S, n) for n in kv_len)
    return dict(flops=4 * d * hq * keys,
                bytes=es * (2 * b * hq * d + 2 * keys * hkv * d) + 4 * b,
                exps=hq * keys, dtype=dtype)


def _key_bytes(d, kes, quant):
    """Bytes of one key of one kv head: its K and V rows, and on a
    quantized pool their two fp32 scales."""
    return 2 * d + 8 if quant else 2 * d * kes


def paged_decode_attention_cost(*, b, nb, bs, hq, hkv, d, es, kes, dtype,
                                kv_len=None, quant=False):
    """#2 / #5: #8 through a block table (b, nb) of bs-key pages; the
    table and the lengths read."""
    keys = b * nb * bs if kv_len is None else sum(kv_len)
    return dict(flops=4 * d * hq * keys,
                bytes=(es * 2 * b * hq * d + keys * hkv * _key_bytes(
                    d, kes, quant) + 4 * (b * nb + b)),
                exps=hq * keys, dtype=dtype)


def paged_chunk_attention_cost(*, b, C, nb, bs, hq, hkv, d, es, kes, dtype,
                               q_start=None, kv_len=None, quant=False):
    """#3 / #4 / #6 / #7: C queries a row at q_start[i] + j attending
    causally to the row's keys below kv_len (a chunk's prior pages plus
    its own; a verify's committed keys plus the candidates): two products
    a kept pair; q read, o written, each row's kv_len keys read once, the
    table and both length vectors read. Without lengths every query sees
    its row's whole table."""
    S = nb * bs
    if kv_len is None:
        pairs, keys = b * C * S, b * S
    else:
        pairs = attention_pairs(b, C, S, causal=True, q_start=q_start,
                                kv_len=kv_len)
        keys = sum(kv_len)
    return dict(flops=4 * d * hq * pairs,
                bytes=(es * 2 * b * C * hq * d + keys * hkv * _key_bytes(
                    d, kes, quant) + 4 * (b * nb + 2 * b)),
                exps=hq * pairs, dtype=dtype)


def ssm_scan_cost(*, b, s, din, ds, in_bytes, states=0):
    """#9: per (row, step, channel) ds exponentials and 6 ds + 3 fp32
    operations (the exponent's product, the state update's product and
    FMA, C's FMA; dt x, D x and the sum); x, dt, A, B, C, D (and h0) read
    once (`in_bytes`), y written in x's dtype (its half of `in_bytes`' x
    is passed in by the caller) and the fp32 final state (and, for
    training, `states` fp32 chunk-entry states)."""
    n = b * s * din
    return dict(flops=n * (6 * ds + 3),
                bytes=in_bytes + 4 * b * din * ds + 4 * states * din * ds,
                exps=n * ds, dtype="fp32")


def ssm_scan_bwd_cost(*, b, s, din, ds, es, bc_es, h_ins):
    """#9's backward: per (row, step, channel, state) 7 fp32
    multiply-adds and one exponential (a[t]); x, dy read and dx written
    (x's dtype), dt read and ddt written (fp32), B, C read and dB, dC
    written, the chunk states h_ins, A, D read and dA, dD, dh0 written
    (fp32)."""
    n = b * s * din * ds
    nbytes = (es * 3 * b * s * din + 4 * 2 * b * s * din
              + bc_es * 4 * b * s * ds
              + 4 * (h_ins + 2 * din * ds + 2 * din + b * din * ds))
    return dict(flops=2 * 7 * n, bytes=nbytes, exps=n, dtype="fp32")


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

def _flash_args(a, lse=False):
    q, k = a["q"], a["k"]
    b, sq, hq, d = (int(x) for x in q.shape)
    return dict(b=b, sq=sq, skv=int(k.shape[1]), hq=hq,
                hkv=int(k.shape[2]), d=d, es=_es(q), dtype=_dtype_name(q),
                causal=a.get("causal", True), window=a.get("window", 0) or 0,
                kv_start=_lens(a.get("kv_start"), b),
                kv_len=_lens(a.get("kv_len"), b),
                **({"lse": True} if lse else {}))


def _flash_call(a):
    """#1 from ops.flash_attention's arguments; ``lse`` marks its training
    instance (the forward of FlashAttentionFn)."""
    return flash_attention_cost(**_flash_args(a, lse=a.get("lse", False)))


def _flash_bwd_call(a):
    return flash_attention_bwd_cost(**_flash_args(a))


def _decode_call(a):
    q, k = a["q"], a["k"]
    b, _, hq, d = (int(x) for x in q.shape)
    return decode_attention_cost(b=b, S=int(k.shape[1]), hq=hq,
                                 hkv=int(k.shape[2]), d=d, es=_es(q),
                                 dtype=_dtype_name(q),
                                 kv_len=_lens(a.get("kv_len"), b))


def _paged_shapes(a):
    q, kp, tbl = a["q"], a["k_pages"], a["block_tables"]
    b, C, hq, d = (int(x) for x in q.shape)
    return dict(b=b, nb=int(tbl.shape[1]), bs=int(kp.shape[1]), hq=hq,
                hkv=int(kp.shape[2]), d=d, es=_es(q), kes=_es(kp),
                dtype=_dtype_name(q),
                quant=a.get("k_scale") is not None), C


def _paged_decode_call(a):
    sh, _ = _paged_shapes(a)
    return paged_decode_attention_cost(kv_len=_lens(a.get("kv_len"),
                                                    sh["b"]), **sh)


def _paged_context_call(a):
    sh, C = _paged_shapes(a)
    start = a.get("q_start", a.get("kv_start"))
    return paged_chunk_attention_cost(
        C=C, q_start=_lens(start, sh["b"]),
        kv_len=_lens(a.get("kv_len"), sh["b"]), **sh)


def _scan_call(a):
    x, A = a["x"], a["A"]
    b, s, din = (int(v) for v in x.shape)
    ds = int(A.shape[-1])
    ins = [a.get(n) for n in ("x", "dt", "A", "B", "C", "D", "h0")]
    in_bytes = sum(_numel(t) * _es(t) for t in ins if t is not None)
    states = b * -(-s // 128) if a.get("states") else 0
    return ssm_scan_cost(b=b, s=s, din=din, ds=ds,
                         in_bytes=in_bytes + _numel(x) * _es(x),
                         states=states)


def _scan_bwd_call(a):
    x, A, B, h_ins = a["x"], a["A"], a["B"], a["h_ins"]
    b, s, din = (int(v) for v in x.shape)
    return ssm_scan_bwd_cost(b=b, s=s, din=din, ds=int(A.shape[-1]),
                             es=_es(x), bc_es=_es(B), h_ins=_numel(h_ins))


def _entry(op, oracle, ports, chip_check, cpu_test, cost):
    return {"op": op, "oracle": oracle, "ports": ports,
            "chip_check": chip_check, "cpu_test": cpu_test, "cost": cost}


# wrapper -> entry; ``cost`` takes an ops entry point's bound arguments
KERNEL_ORACLES: Dict[str, Dict] = {
    "flash_attention_cuda": _entry(
        "flash_attention", "attention_ref", "flash_attention_pallas",
        "check_kernels", "tests/test_torch_kernels.py", _flash_call),
    "paged_decode_attention_cuda": _entry(
        "paged_decode_attention", "paged_decode_attention_ref",
        "paged_decode_attention_pallas", "check_kernels",
        "tests/test_torch_kernels.py", _paged_decode_call),
    "paged_context_attention_cuda": _entry(
        "paged_context_attention", "paged_context_attention_ref",
        "paged_context_attention_pallas", "check_kernels",
        "tests/test_torch_kernels.py", _paged_context_call),
    "paged_verify_attention_cuda": _entry(
        "paged_verify_attention", "paged_verify_attention_ref",
        "paged_verify_attention_pallas", "check_kernels",
        "tests/test_torch_spec.py", _paged_context_call),
    "paged_decode_attention_quant_cuda": _entry(
        "paged_decode_attention_quant", "paged_decode_attention_quant_ref",
        "paged_decode_attention_quant_pallas", "check_kernels",
        "tests/test_torch_quant.py", _paged_decode_call),
    "paged_context_attention_quant_cuda": _entry(
        "paged_context_attention_quant",
        "paged_context_attention_quant_ref",
        "paged_context_attention_quant_pallas", "check_kernels",
        "tests/test_torch_quant.py", _paged_context_call),
    "paged_verify_attention_quant_cuda": _entry(
        "paged_verify_attention_quant", "paged_verify_attention_quant_ref",
        "paged_verify_attention_quant_pallas", "check_kernels",
        "tests/test_torch_quant.py", _paged_context_call),
    "decode_attention_cuda": _entry(
        "decode_attention", "decode_attention_ref",
        "decode_attention_pallas", "check_kernels",
        "tests/test_torch_static.py", _decode_call),
    "ssm_scan_cuda": _entry(
        "ssm_scan", "ssm_scan_ref", "ssm_scan_pallas", "check_scan",
        "tests/test_torch_hybrid.py", _scan_call),
    "flash_attention_bwd_cuda": _entry(
        "flash_attention_bwd", "attention_bwd_ref", "_fa_full_bwd",
        "check_bwd_kernels", "tests/test_torch_train.py", _flash_bwd_call),
    "ssm_scan_bwd_cuda": _entry(
        "ssm_scan_bwd", "ssm_scan_bwd_ref", "_ssm_chunks_bwd",
        "check_bwd_kernels", "tests/test_torch_train.py", _scan_bwd_call),
}

BY_OP = {e["op"]: name for name, e in KERNEL_ORACLES.items()}


def call_cost(op: str, arguments: dict) -> dict:
    """The cost of one call of op (a key of ``kernels.ops.KERNELS``) from
    the bound arguments of its ``kernels.ops`` entry point."""
    return KERNEL_ORACLES[BY_OP[op]]["cost"](arguments)


# ---------------------------------------------------------------------------
# Validation against the tree
# ---------------------------------------------------------------------------

def repo_root() -> str:
    """The checkout root (this file lives at src/repro_torch/analysis/)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _top_level_defs(path: str) -> List[Tuple[str, int]]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    return [(n.name, n.lineno) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def cuda_kernels(root: Optional[str] = None
                 ) -> Dict[str, Tuple[str, int]]:
    """Scan ``KERNEL_MODULES`` for top-level ``*_cuda`` definitions;
    returns {wrapper name: (repo-relative path, line)}."""
    root = root if root is not None else repo_root()
    found: Dict[str, Tuple[str, int]] = {}
    for rel in KERNEL_MODULES:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        for name, line in _top_level_defs(path):
            if name.endswith("_cuda"):
                found[name] = (rel, line)
    return found


def _names(text: str, names: Sequence[str]) -> bool:
    return any(re.search(rf"\b{re.escape(n)}\b", text) for n in names)


def _read(path: str) -> Optional[str]:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return f.read()


def check_registry(root: Optional[str] = None) -> List[str]:
    """Validate the registry against the tree. Returns human-readable
    problems (empty = sound): unregistered wrappers, stale entries,
    missing twins, a ``ports`` the reference does not define, and a
    ``chip_check`` or ``cpu_test`` that is missing or never names the
    wrapper, its op or its twin."""
    root = root if root is not None else repo_root()
    problems: List[str] = []
    kernels = cuda_kernels(root)
    for name, (rel, line) in sorted(kernels.items()):
        if name not in KERNEL_ORACLES:
            problems.append(
                f"{rel}:{line} kernel '{name}' has no registered oracle "
                "(add it to repro_torch.analysis.registry.KERNEL_ORACLES)")
    oracle_path = os.path.join(root, ORACLE_MODULE)
    oracles = {n for n, _ in _top_level_defs(oracle_path)} \
        if os.path.exists(oracle_path) else set()
    chip = _read(os.path.join(root, CHIP_SMOKE))
    chip_defs = ({n for n, _ in _top_level_defs(
        os.path.join(root, CHIP_SMOKE))} if chip is not None else set())
    ref_ops = _read(os.path.join(root, REFERENCE_OPS)) or ""
    ref_kernels = set()
    for rel in ("src/repro/kernels/flash_attention.py",
                "src/repro/kernels/paged_attention.py",
                "src/repro/kernels/decode_attention.py",
                "src/repro/kernels/ssm_scan.py"):
        text = _read(os.path.join(root, rel))
        if text is not None:
            ref_kernels |= set(re.findall(r"^def (\w+_pallas)\(", text,
                                          re.M))
    for name, entry in sorted(KERNEL_ORACLES.items()):
        if name not in kernels:
            problems.append(
                f"registry entry '{name}' matches no *_cuda definition "
                f"in {', '.join(KERNEL_MODULES)} (stale registry?)")
        oracle = entry["oracle"]
        if oracle not in oracles:
            problems.append(
                f"registry entry '{name}': oracle '{oracle}' not found in "
                f"{ORACLE_MODULE}")
        ports = entry["ports"]
        if ports not in ref_kernels and not re.search(
                rf"^def {re.escape(ports)}\(", ref_ops, re.M):
            problems.append(
                f"registry entry '{name}': ports '{ports}', which the "
                "reference's kernels and ops do not define")
        names = (name, entry["op"], oracle)
        if entry["chip_check"] not in chip_defs:
            problems.append(
                f"registry entry '{name}': chip check "
                f"'{entry['chip_check']}' not defined in {CHIP_SMOKE}")
        elif not _names(chip, names):
            problems.append(
                f"registry entry '{name}': {CHIP_SMOKE} never names "
                f"'{name}', '{entry['op']}' or '{oracle}'")
        test = _read(os.path.join(root, entry["cpu_test"]))
        if test is None:
            problems.append(f"registry entry '{name}': CPU test file "
                            f"{entry['cpu_test']} missing")
        elif not _names(test, (oracle,)):
            problems.append(f"registry entry '{name}': "
                            f"{entry['cpu_test']} never runs '{oracle}'")
    return problems
