"""Weight bridge: the reference's parameter tree as numpy arrays -> the
port's tensors, and back.

The JAX package's ``repro.models.model.init_params`` returns a nested dict
whose layer leaves are stacked on a leading period axis (``blocks/sub{j}``
for each position j of a period), which the port's model code reads as it
is (``models.model``), an encoder-decoder's ``encoder`` subtree, LayerNorm
biases and cross-attention and a tied-embedding model's tree without
``lm_head`` included: the bridge walks any nested dict. Weights keep
the reference's (in, out) layout, so every product stays ``x @ w`` and a
bridged model computes the same function as the reference. The bridge
takes and returns numpy only; converting a JAX tree to numpy is the
caller's step (``jax.tree.map(np.asarray, params)``). A weight-only int8
leaf of a quantized tree ({"q": int8, "s": float32}) bridges as it is:
``dtype`` casts float leaves only, never a quantized leaf's payload or
scales, nor a Mamba layer's float32 dynamics (``A_log``, ``D``,
``dt_bias``: ``models.mamba.FP32_LEAVES``), which stay float32 in every
model dtype, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.mamba import FP32_LEAVES
from repro_torch.models.quant import is_quantized


def params_from_numpy(tree, *, device, dtype=None):
    """Nested dict of numpy arrays -> the same dict of tensors on `device`
    (float leaves cast to `dtype` when given, except a quantized {"q", "s"}
    leaf's and the FP32_LEAVES)."""
    if isinstance(tree, dict):
        keep = is_quantized(tree)
        return {k: params_from_numpy(
            v, device=device,
            dtype=None if keep or k in FP32_LEAVES else dtype)
            for k, v in tree.items()}
    t = torch.tensor(np.asarray(tree))        # a copy: inputs may be read-only
    cast = dtype is not None and t.is_floating_point()
    return t.to(device=device, dtype=dtype if cast else t.dtype)


def params_to_numpy(tree):
    """Nested dict of tensors -> the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
