"""Training step (twin of repro.training.train_step): the loss, its
gradient by ``backward()``, then the AdamW update under
``torch.no_grad()``. Attention and the Mamba scan differentiate through
their hand-written backward kernels on the card (``kernels.ops``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.training import optimizer


def make_train_step(cfg: ModelConfig, opt_cfg: optimizer.AdamWConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    loss): params and moments updated in place (optimizer.apply), the loss
    a detached float32 scalar. Every float leaf of params takes part."""
    def train_step(params, opt_state, batch):
        leaves = [p for p in optimizer.leaves(params)
                  if p.is_floating_point()]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss = M.loss_fn(cfg, params, batch)
        loss.backward()
        grads = optimizer.tree_map(lambda p: p.grad, params)
        new_params, new_state = optimizer.apply(opt_cfg, grads, opt_state,
                                                params)
        for p in leaves:
            p.grad = None
        return new_params, new_state, loss.detach()
    return train_step
