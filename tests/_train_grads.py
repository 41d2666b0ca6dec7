"""Shared body of test_torch_train_grads*.py: the port's train_forward,
loss_fn and every gradient leaf against jax.value_and_grad of the
reference's loss_fn on one reduced architecture (weights bridged from
repro.models.model.init_params, inputs from a numpy seed, fp32)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import ops
from repro_torch.models import model as PM

B, S = 2, 16


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.num_image_tokens:
        batch["image_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return batch


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def check_arch(arch):
    cfg = get_config(arch).reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits_want, aux_want = JM.train_forward(cfg, params, jb)
    loss_want, grads = jax.value_and_grad(
        lambda p: JM.loss_fn(cfg, p, jb))(params)
    grads = dict(_named_leaves(jax.tree.map(np.asarray, grads)))

    pcfg = port_config(arch).reduced()
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
    leaves = dict(_named_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, aux = PM.train_forward(pcfg, tp, batch)
    assert logits.shape == (B, S + cfg.num_image_tokens, cfg.vocab_size)
    assert np.abs(logits.numpy() - np.asarray(logits_want)).max() <= 1e-5
    assert abs(float(aux) - float(aux_want)) <= 1e-5
    loss = PM.loss_fn(pcfg, tp, batch)
    loss.backward()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert abs(float(loss.detach()) - float(loss_want)) <= \
        1e-4 * abs(float(loss_want))
    assert sorted(leaves) == sorted(grads)
    for name, t in leaves.items():
        want = grads[name]
        got = (t.grad.numpy() if t.grad is not None
               else np.zeros_like(want))
        tol = 1e-4 * max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= tol, name
