"""npz checkpoints in the reference's layout (twin of
repro.checkpoint.ckpt), so that a checkpoint written by either package
restores into the other.

Layout: <dir>/step_<n>/params.npz + opt_state.npz + meta.json. Trees are
flattened with '/'-joined key paths (``blocks/sub0/mixer/wq``; an
AdamWState as ``step``, ``mu/...``, ``nu/...``). numpy has no bfloat16 and
the card's machine has no ml_dtypes, so a bf16 leaf is written as float32
(exact) and every leaf is cast to its like-tree leaf's dtype on restore,
as the reference's restore does; a reference checkpoint's bf16 arrays
(numpy's 2-byte void) are read as bf16 bits.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState


def _tree(state):
    """An AdamWState as the dict the reference's key paths name."""
    if isinstance(state, AdamWState):
        return {"step": state.step, "mu": state.mu, "nu": state.nu}
    return state


def _flatten(tree, prefix="") -> Dict[str, torch.Tensor]:
    tree = _tree(tree)
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bf16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save(path: str, step: int, params, opt_state: Any = None,
         extra: Optional[dict] = None) -> str:
    d = os.path.join(path, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "params.npz"),
             **{k: _to_numpy(v) for k, v in _flatten(params).items()})
    if opt_state is not None:
        np.savez(os.path.join(d, "opt_state.npz"),
                 **{k: _to_numpy(v) for k, v in _flatten(opt_state).items()})
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    return d


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for n in os.listdir(path)
             if (m := re.match(r"step_(\d+)$", n))]
    return max(steps) if steps else None


def _unflatten(like, blob, prefix=""):
    if isinstance(like, AdamWState):
        t = _unflatten(_tree(like), blob, prefix)
        return AdamWState(step=t["step"], mu=t["mu"], nu=t["nu"])
    if isinstance(like, dict):
        return {k: _unflatten(v, blob, f"{prefix}{k}/")
                for k, v in like.items()}
    key = prefix[:-1]
    arr = blob[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: checkpoint shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    return _to_tensor(arr, like)


def restore(path: str, step: int, params_like, opt_like=None
            ) -> Tuple[Any, Any, dict]:
    """Restores into the structure, devices and dtypes of `params_like`
    (and `opt_like`); shapes are checked."""
    d = os.path.join(path, f"step_{step:08d}")
    with np.load(os.path.join(d, "params.npz")) as blob:
        params = _unflatten(params_like, blob)
    opt = None
    if opt_like is not None:
        with np.load(os.path.join(d, "opt_state.npz")) as blob:
            opt = _unflatten(opt_like, blob)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return params, opt, meta
