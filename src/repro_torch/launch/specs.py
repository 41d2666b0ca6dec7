"""The dry run's inputs and step functions for every (arch x input shape)
(the port of repro.launch.specs, without a mesh or shardings: the port
runs on one card).

On the meta device every tensor is a shape and a dtype and nothing is
allocated; on the card the same step runs on seeded values. ``layers`` and
``batch`` cut the configuration and the input shape to what one card
holds; each cut is listed in the returned ``reduced``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
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


def build_dryrun(arch: str, shape_name: str, *, device="meta",
                 layers: Optional[int] = None, batch: Optional[int] = None,
                 seed: int = 0):
    """Returns (step_fn, args tuple, cfg, shape, reduced). The step is the
    reference's: a train step (``loss_fn``, ``backward()``, AdamW's
    ``apply``) on (params, opt_state, batch); ``prefill`` on (params,
    batch, cache of seq_len); one ``decode_step`` on (params, tokens (b,),
    a cache of seq_len, pos = seq_len - 1)."""
    cfg = resolve_config(arch, shape_name)
    cfg, shape, reduced = cut(cfg, INPUT_SHAPES[shape_name], layers=layers,
                              batch=batch)
    dev = resolve_device(device)
    params = params_struct(cfg, device=dev, seed=seed)
    bstruct = token_struct(cfg, shape, device=dev, seed=seed + 1)

    if shape.kind == "train":
        ostate = optimizer.init(params)
        fn = make_train_step(cfg, optimizer.AdamWConfig())
        return fn, (params, ostate, bstruct), cfg, shape, reduced

    b = shape.global_batch
    cache = cache_struct(cfg, b, shape.seq_len, device=dev)
    if shape.kind == "prefill":
        def prefill_fn(params, batch, cache):
            return M.prefill(cfg, params, batch, cache)
        return prefill_fn, (params, bstruct, cache), cfg, shape, reduced

    # decode: one new token against a cache of seq_len
    tokens = torch.randint(0, cfg.vocab_size, (b,), generator=_gen(dev, seed),
                           device=dev, dtype=torch.int32)
    pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=dev)

    def decode_fn(params, tokens, cache, pos):
        return M.decode_step(cfg, params, tokens, cache, pos)
    return decode_fn, (params, tokens, cache, pos), cfg, shape, reduced
