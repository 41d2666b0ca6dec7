"""Quantization of the port (twin of repro.models.quant): weight-only int8
matmul weights, and int8 / fp8 KV page pools.

Weights: per-output-channel symmetric int8. A matmul weight W (..., in, out)
becomes {"q": int8, "s": float32 (..., out)}, and ``mm`` applies the scales
after the product, x @ W ~ (x @ q) * s, in the reference's order. Every
weight product of the model code goes through ``mm``, so a quantized tree
replaces the plain one leaf for leaf.

KV pages: a pool (n_blocks, block_size, hkv, d) stored at int8 or fp8 e4m3
gets float32 per-token-per-head scale pools (n_blocks, block_size, hkv),
``k_scale`` / ``v_scale``, addressed by the same block ids, and every row
dequantizes as payload.float() * scale. The paged kernels fuse that
dequantization (``kernels.paged_attention``).
"""
from __future__ import annotations

import torch

# weight leaf names eligible for quantization (matmul weights only: norms
# and the embedding gather stay full)
QUANT_LEAVES = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
    "out_proj", "x_proj", "dt_proj", "lm_head",
    "w_z", "w_i", "w_f", "w_o",
}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def mm(x, w):
    """x @ w for a plain or quantized 2-D w (dequantization as a post-scale
    on the product)."""
    if is_quantized(w):
        y = x @ w["q"].to(x.dtype)
        return y * w["s"].to(x.dtype)
    return x @ w


def _quantize_2d(wf):
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-2)


def quantize_leaf(w):
    """Symmetric int8 with one scale per output column: (in, out) -> s
    (out,); a layer-stacked (L, in, out) -> s (L, out), one layer at a time
    so a full-width model needs one layer's float32 copy, not the stack's."""
    if w.dim() == 2:
        q, s = _quantize_2d(w.float())
        return {"q": q, "s": s.float()}
    parts = [quantize_leaf(w[i]) for i in range(w.shape[0])]
    return {"q": torch.stack([p["q"] for p in parts]),
            "s": torch.stack([p["s"] for p in parts])}


def dequantize_leaf(wq):
    return wq["q"].float() * wq["s"].unsqueeze(-2).float()


def quantize_params(params):
    """Quantize every eligible matmul weight (2-D and up) of the tree."""

    def walk(tree, name=""):
        if isinstance(tree, dict) and not is_quantized(tree):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in QUANT_LEAVES and torch.is_tensor(tree) and tree.dim() >= 2:
            return quantize_leaf(tree)
        return tree

    return walk(params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quant_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


# ---------------------------------------------------------------------------
# KV pages
# ---------------------------------------------------------------------------

# kv_dtype name -> (storage dtype, qmax, integer rounding). fp32 / bf16 are
# unquantized layouts (no scale leaves); int8 / fp8 store scaled payloads.
# fp8 is e4m3 (max finite 448): range lives in the scale.
KV_DTYPES = {
    "fp32": (torch.float32, None, False),
    "bf16": (torch.bfloat16, None, False),
    "int8": (torch.int8, 127.0, True),
    "fp8": (torch.float8_e4m3fn, 448.0, False),
}

KV_SCALE_LEAVES = ("k_scale", "v_scale")


def _kv(kv_dtype: str):
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r}: one of {sorted(KV_DTYPES)}")
    return KV_DTYPES[kv_dtype]


def kv_storage_dtype(kv_dtype: str) -> torch.dtype:
    return _kv(kv_dtype)[0]


def kv_dtype_name(storage_dtype) -> str:
    """Quantized kv_dtype name of a pool payload dtype (int8 -> "int8",
    float8_e4m3fn -> "fp8")."""
    for name, (dt, qmax, _) in KV_DTYPES.items():
        if qmax is not None and storage_dtype == dt:
            return name
    raise ValueError(f"not a quantized KV storage dtype: {storage_dtype}")


def kv_is_quantized(kv_dtype: str) -> bool:
    return _kv(kv_dtype)[1] is not None


def kv_itemsize(kv_dtype: str) -> int:
    """Payload bytes per cache element (the scales' 4 bytes per token and
    head come on top)."""
    return torch.empty((), dtype=kv_storage_dtype(kv_dtype)).element_size()


def quantize_kv_rows(rows, kv_dtype: str):
    """K or V rows (..., h, d) -> (payload (..., h, d) in the storage
    dtype, scale (..., h) float32), symmetric per token and head: scale =
    amax over d / qmax."""
    dt, qmax, rnd = _kv(kv_dtype)
    if qmax is None:
        raise ValueError(f"kv_dtype {kv_dtype!r} is not quantized")
    rf = rows.float()
    amax = rf.abs().amax(-1)
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = rf / scale[..., None]
    if rnd:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(dt), scale.float()


def dequantize_kv(payload, scale):
    """Inverse of quantize_kv_rows: payload (..., h, d), scale (..., h)."""
    return payload.float() * scale[..., None].float()


def bits(t):
    """A one-byte payload as uint8 (the same bytes), so that copies and
    scatters work for every payload dtype on every device (index_copy_
    has no float8 kernel on the CPU); other tensors as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
