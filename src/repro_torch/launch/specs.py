"""The dry run's inputs and step functions for every (arch x input shape)
(the port of repro.launch.specs).

On the meta device every tensor is a shape and a dtype and nothing is
allocated; on the card the same step runs on seeded values. ``layers`` and
``batch`` cut the configuration and the input shape to what one card
holds; each cut is listed in the returned ``reduced``.

On a mesh (``launch.mesh``; the reference's production (16, 16) or any
(data, model) shape) the step is card 0's share of it, as the
reference's SPMD partition gives each chip its own: the batch cut over
the data axes (``batch_axes``), the parameters cut for shard 0 of the
model axis (``models.model.card_params``: the executor's
``shard_layer_params``), the cache cut as the reference's
``cache_specs`` cuts it (``card_cache``), and the step run under
``models.parallel_ctx.use_mesh``, which counts each reduction the card
would share as a collective.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models import moe, parallel_ctx, shardings
from repro_torch.training import optimizer
from repro_torch.training.train_step import make_train_step

# full-attention archs run long_500k only as a documented sliding-window
# variant (DESIGN.md "Shape skips"); whisper-base skips it entirely.
SWA_OVERRIDE_WINDOW = 8192
LONG_SKIP = {"whisper-base"}


def resolve_config(arch: str, shape_name: str) -> ModelConfig:
    cfg = get_config(arch)
    if shape_name == "long_500k":
        if arch in LONG_SKIP:
            raise ValueError(f"{arch} skips long_500k (see DESIGN.md)")
        sub_quadratic = cfg.family in ("hybrid", "ssm") or cfg.swa_window
        if not sub_quadratic:
            cfg = dataclasses.replace(cfg, swa_window=SWA_OVERRIDE_WINDOW)
    return cfg


def _gen(device, seed):
    dev = torch.device(device)
    return None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)


def token_struct(cfg: ModelConfig, shape: InputShape, *, device="meta",
                 seed: int = 0):
    """The batch dict (text tokens + modality stubs) of a train step or a
    prefill: tokens (b, s - num_image_tokens) int32, paligemma's
    image_embeds (b, num_image_tokens, d) and whisper's enc_frames (b,
    encoder_seq_len, d) in the model's dtype; seeded values on a real
    device. A decode step takes none."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {}
    dev, g = resolve_device(device), _gen(device, seed)
    dt = M.param_dtype(cfg)

    def noise(*dims):
        return torch.empty(dims, dtype=dt, device=dev).normal_(
            0.0, 1.0, generator=g)
    st = s - cfg.num_image_tokens
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, st),
                                     generator=g, device=dev,
                                     dtype=torch.int32)}
    if cfg.num_image_tokens:
        batch["image_embeds"] = noise(b, cfg.num_image_tokens, cfg.d_model)
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = noise(b, cfg.encoder_seq_len, cfg.d_model)
    return batch


def params_struct(cfg: ModelConfig, *, device="meta", seed: int = 0):
    return M.init_params(cfg, seed, device=device)


def cache_struct(cfg: ModelConfig, batch: int, max_len: int, *,
                 device="meta"):
    return M.init_cache(cfg, batch, max_len, device=device)


def cut(cfg: ModelConfig, shape: InputShape, *, layers=None, batch=None):
    """(cfg, shape, reduced): `layers` of cfg's decoder layers (a whole
    number of its periods) and `batch` of the shape's sequences; reduced
    lists each cut as "what: kept of full"."""
    reduced: List[str] = []
    if layers is not None and layers != cfg.num_layers:
        reduced.append(f"layers: {layers} of {cfg.num_layers}")
        cfg = dataclasses.replace(cfg, num_layers=layers)
        M.n_periods(cfg)                 # a whole number of periods
    if batch is not None and batch != shape.global_batch:
        reduced.append(f"batch: {batch} of {shape.global_batch}")
        shape = dataclasses.replace(shape, global_batch=batch)
    return cfg, shape, reduced


def batch_axes(shape: InputShape, multi_pod: bool, mesh):
    """The data axes a step's batch splits over on `mesh`, as the
    reference's ``batch_specs`` gives them: all of them where they divide
    the batch, none (None) for a batch smaller than them, else the last
    one."""
    d = mesh_lib.data_axes(multi_pod)
    b = shape.global_batch
    nd = _axes_size(mesh, d)
    return d if b % nd == 0 else (None if b < nd else d[-1])


def _axes_size(mesh, axes) -> int:
    """The size of a spec entry: None, one axis name or a tuple of them."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.axis_size(axes)
    n = 1
    for ax in axes:
        n *= mesh.axis_size(ax)
    return n


def card_cache(cfg: ModelConfig, cache, mesh, bspec, *,
               shard_seq_over_data=False,
               seq_over_model_if_kv_replicated=False):
    """Card 0's share of a contiguous cache tree ({"sub{j}": ...}, leaves
    (P, batch, ...)), as the reference's ``cache_specs`` cuts it: the
    batch over `bspec`'s data axes (or, with ``shard_seq_over_data``, the
    K/V sequence instead: long_500k's context parallelism); K / V and
    cross K / V on their kv heads where the model axis divides them, else,
    with ``seq_over_model_if_kv_replicated``, every kv head on 1/tp of the
    sequence (the card's share of a flash-decode,
    ``models.model._attn_decode``), else shard 0's kv heads
    (``shardings.shard_heads``); Mamba's conv and state on din where it
    divides. Views of `cache`'s leaves."""
    tp = mesh.axis_size(mesh_lib.MODEL_AXIS)
    nd = _axes_size(mesh, bspec)

    def cut(t, dim, n):
        return t.narrow(dim, 0, t.shape[dim] // n) if n > 1 else t

    def leaf(name, t):
        if name in ("k", "v", "cross_k", "cross_v"):
            S, hkv = t.shape[2], t.shape[3]
            k0, k1 = (shardings.shard_heads(cfg, tp)[0][1] if tp > 1
                      else (0, hkv))
            if shard_seq_over_data:
                return cut(t.narrow(3, k0, k1 - k0), 2, nd)
            t = cut(t, 1, nd)
            if (tp > 1 and hkv % tp and seq_over_model_if_kv_replicated
                    and S % tp == 0):
                return cut(t, 2, tp)       # every kv head, 1/tp of the keys
            return t.narrow(3, k0, k1 - k0)
        t = cut(t, 1, nd)
        if name == "conv" and t.shape[3] % tp == 0:
            return cut(t, 3, tp)
        if name == "h" and t.dim() == 4 and t.shape[2] % tp == 0:
            return cut(t, 2, tp)
        return t
    return {j: {n: leaf(n, t) for n, t in sub.items()}
            for j, sub in cache.items()}


def _on_mesh(fn, mesh, multi_pod):
    """fn under the mesh's parallel context (the model's card views)."""
    def wrapped(*a):
        with parallel_ctx.use_mesh(mesh, mesh_lib.data_axes(multi_pod),
                                   mesh_lib.MODEL_AXIS):
            return fn(*a)
    return wrapped


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def build_dryrun(arch: str, shape_name: str, *, device="meta",
                 layers: Optional[int] = None, batch: Optional[int] = None,
                 seed: int = 0, mesh=None, multi_pod: bool = False):
    """Returns (step_fn, args tuple, cfg, shape, reduced). The step is the
    reference's: a train step (``loss_fn``, ``backward()``, AdamW's
    ``apply``) on (params, opt_state, batch); ``prefill`` on (params,
    batch, cache of seq_len); one ``decode_step`` on (params, tokens (b,),
    a cache of seq_len, pos = seq_len - 1). With a `mesh`
    (``launch.mesh.Mesh``) it is card 0's share of that step (the module
    docstring), a train step's gradients each counted as a data-parallel
    all-reduce where the batch splits over the data axes."""
    cfg = resolve_config(arch, shape_name)
    cfg, shape, reduced = cut(cfg, INPUT_SHAPES[shape_name], layers=layers,
                              batch=batch)
    dev = resolve_device(device)
    params = params_struct(cfg, device=dev, seed=seed)
    b = shape.global_batch
    bspec = nd = tp = None
    if mesh is not None:
        tp = mesh.axis_size(mesh_lib.MODEL_AXIS)
        if cfg.num_experts and moe.MOE_DISPATCH == "global" and \
                mesh.size > tp:
            raise NotImplementedError(
                f"{arch}: MOE_DISPATCH 'global' on a mesh with a data "
                f"axis ({mesh.shape}): the reference's ranks span every "
                "data card's rows (GSPMD gathers them), which card 0's "
                "share does not hold")
        bspec = batch_axes(shape, multi_pod, mesh)
        nd = _axes_size(mesh, bspec)
        params = _clone(M.card_params(cfg, params, tp))
        b //= nd
    bstruct = token_struct(cfg, dataclasses.replace(shape, global_batch=b),
                           device=dev, seed=seed + 1)

    def step(fn):
        return fn if mesh is None else _on_mesh(fn, mesh, multi_pod)

    def card(cache, **kw):
        # on a mesh, card 0's share of the whole cache, made on `dev` from
        # its shapes (the whole one is never allocated)
        if mesh is None:
            return cache
        return {j: {n: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                    for n, t in sub.items()}
                for j, sub in card_cache(cfg, cache, mesh, bspec,
                                         **kw).items()}
    cache_dev = dev if mesh is None else "meta"

    if shape.kind == "train":
        ostate = optimizer.init(params)
        if nd is not None and nd > 1:
            for p in optimizer.leaves(params):
                if p.is_floating_point():
                    p.requires_grad_(True)
                    p.register_post_accumulate_grad_hook(
                        lambda p: parallel_ctx.count("all-reduce", p.grad))
        fn = step(make_train_step(cfg, optimizer.AdamWConfig()))
        return fn, (params, ostate, bstruct), cfg, shape, reduced

    if shape.kind == "prefill":
        cache = card(cache_struct(cfg, shape.global_batch, shape.seq_len,
                                  device=cache_dev))

        def prefill_fn(params, batch, cache):
            return M.prefill(cfg, params, batch, cache)
        return step(prefill_fn), (params, bstruct, cache), cfg, shape, reduced

    # decode: one new token against a cache of seq_len
    cache = card(cache_struct(cfg, shape.global_batch, shape.seq_len,
                              device=cache_dev),
                 shard_seq_over_data=shape.global_batch == 1,
                 seq_over_model_if_kv_replicated=True)
    tokens = torch.randint(0, cfg.vocab_size, (b,), generator=_gen(dev, seed),
                           device=dev, dtype=torch.int32)
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=dev)

    def decode_fn(params, tokens, cache, pos):
        return M.decode_step(cfg, params, tokens, cache, pos)
    return step(decode_fn), (params, tokens, cache, pos), cfg, shape, reduced
