"""AdamW with a cosine schedule and global-norm clipping (twin of
repro.training.optimizer) on the port's nested param dicts.

The reference's order of operations is kept: the clip scale from the
float32 global norm of every gradient leaf, ``step`` incremented before
``lr_at``, bias corrections ``1 - b ** step``, weight decay on leaves of
two or more dims (a stacked leaf, so a norm weight (P, d) is decayed), the
moments and the update in float32, cast back to the leaf's dtype. Unlike
the reference's pure function, ``apply`` updates the params and moments
in place (under ``torch.no_grad()``) and returns them: a full-width model
on the card has no room for a second copy of either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    mu: Any                   # float32 tree like the params
    nu: Any


def leaves(tree):
    """The tensors of a nested dict in the reference's flattening order
    (keys sorted at every level, as jax.tree.leaves takes a dict)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def lr_at(cfg: AdamWConfig, step):
    """The learning rate at `step` (a tensor), float32: linear warm-up,
    then a cosine from lr down to min_lr_frac lr at total_steps."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


@torch.no_grad()
def apply(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step, in place. grads: the params' tree of gradients
    (None where a leaf got none: zeros). Returns (params, new_state)."""
    ps, gs = leaves(params), leaves(grads)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for p, g, mu, nu in zip(ps, gs, leaves(state.mu), leaves(state.nu)):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step_dir = (mu / b1c).div_(torch.sqrt(nu / b2c).add_(cfg.eps))
        pf = p.float()
        if p.dim() >= 2:                       # decay matrices only
            step_dir.add_(cfg.weight_decay * pf)
        p.copy_(pf.sub_(lr * step_dir))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
