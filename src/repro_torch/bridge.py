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
model dtype, as in the reference. Gradients bridge as params do (a bf16
leaf comes back as float32, which holds it exactly: numpy has no bf16);
the optimizer's state as ``adamw_state_from_numpy`` /
``adamw_state_to_numpy``, over the reference's AdamWState fields.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.mamba import FP32_LEAVES
from repro_torch.models.quant import is_quantized
from repro_torch.training.optimizer import AdamWState


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
    """Nested dict of tensors -> the same dict of numpy arrays (bf16 as
    float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def adamw_state_from_numpy(state, *, device) -> AdamWState:
    """An AdamWState of numpy leaves (the reference's, or any object with
    its step / mu / nu fields) -> the port's on `device`."""
    return AdamWState(
        step=torch.tensor(np.asarray(state.step), dtype=torch.int32,
                          device=device),
        mu=params_from_numpy(state.mu, device=device),
        nu=params_from_numpy(state.nu, device=device))


def adamw_state_to_numpy(state: AdamWState) -> AdamWState:
    """The port's AdamWState -> the same fields as numpy."""
    return AdamWState(step=state.step.cpu().numpy(),
                      mu=params_to_numpy(state.mu),
                      nu=params_to_numpy(state.nu))
