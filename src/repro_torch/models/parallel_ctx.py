"""Ambient parallel context of the dry run (the port of
repro.models.parallel_ctx): ``launch.specs`` sets it while it counts card
0's share of a step on a production mesh (``launch.mesh``); serving,
training and the CPU tests leave it unset.

While it is set, ``models.model`` reads each layer of a card's parameter
tree (``card_params``) as that card's shard of a stage over the mesh's
model axis, and each reduction a shard would share with the others (a
row-parallel product's sum, a gathered activation, a vocabulary-split
embedding's lookup) as a collective: ``collective`` adds its
per-partition result bytes to the innermost op counter's ``coll_bytes``
under the reference's kind names (``all-reduce``, ``all-gather``), in
the forward and, for training, once more in the backward.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops

MESH = None                         # launch.mesh.Mesh
DATA_AXES: Tuple[str, ...] = ()     # ("data",) or ("pod", "data")
MODEL_AXIS: Optional[str] = None    # "model"


@contextlib.contextmanager
def use_mesh(mesh, data_axes, model_axis):
    global MESH, DATA_AXES, MODEL_AXIS
    prev = (MESH, DATA_AXES, MODEL_AXIS)
    MESH, DATA_AXES, MODEL_AXIS = mesh, tuple(data_axes), model_axis
    try:
        yield
    finally:
        MESH, DATA_AXES, MODEL_AXIS = prev


def active() -> bool:
    return MESH is not None


def tp() -> int:
    """The model axis' size under the active mesh (1 without one)."""
    return MESH.axis_size(MODEL_AXIS) if active() else 1


def count(kind: str, t) -> None:
    """Count a collective of `kind` whose per-partition result is `t` (its
    shape and dtype) in the innermost op counter, if any."""
    if ops.COUNTERS:
        ops.COUNTERS[-1].collective(kind, t.numel() * t.element_size())


class _Collective(torch.autograd.Function):
    """Identity that counts a collective of its result's bytes, and in
    the backward one of its gradient's (a row-parallel sum's conjugate)."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        count(kind, t)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        count(ctx.kind, g)
        return g, None


def collective(kind: str, t):
    """`t`, counted as the result of a collective of `kind` on this card."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Collective.apply(t, kind)
    count(kind, t)
    return t
