"""The dry run's products against the reference's: for reduced llama2-70b,
jamba-v0.1-52b, granite-moe-3b-a800m, xlstm-125m, whisper-base and
paligemma-3b, the prefill, the decode step and the train step, the
port's plain-mode (``ops.backend("plain")``, what the reference's default
"xla" backend compiles) matmul FLOPs on the meta device equal the
``dot_general`` FLOPs of ``jax.make_jaxpr`` of the reference's same step,
walked through scan (times its length), pjit, remat and custom_vjp, but
for xlstm-125m's prefill and train steps, whose difference the test
names (XLSTM_RTOL). And a step counted on the meta device counts what it counts on the CPU, kernel
ops by formula, as chip_smoke.py's phase 11 requires of the card."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jconfig
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training.train_step import make_train_step as jtrain_step
from repro_torch.configs import get_config as pconfig
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, specs
from repro_torch.models import model as PM
from repro_torch.training import optimizer as PO
from repro_torch.training.train_step import make_train_step as ptrain_step

ARCHS = ("llama2-70b", "jamba-v0.1-52b", "granite-moe-3b-a800m",
         "xlstm-125m", "whisper-base", "paligemma-3b")
KINDS = {"prefill": "prefill_32k", "decode": "decode_32k",
         "train": "train_4k"}
B, S = 2, 32
# The one family whose count differs, and why: xlstm-125m. The mLSTM's
# three-operand carry einsum "bshk,bsh,bshv->bhkv" (kernels/ops.py's
# mlstm_scan, the reference's alike): XLA's einsum path multiplies the
# decay rdec into v as a dot_general with nothing to contract (2 b s h v
# more "FLOPs" a chunk), where PyTorch's path multiplies them elementwise;
# in the train step JAX's transposes of that product and of the sLSTM's
# lax.scan contract further pairs that PyTorch's autograd of the port's
# Python loops multiplies and sums. The decode step agrees exactly.
XLSTM_RTOL = {"prefill": 0.001, "train": 0.03}


def _prod(xs):
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _subjaxprs(eqn):
    for v in eqn.params.values():
        for w in (v if isinstance(v, (tuple, list)) else (v,)):
            if hasattr(w, "jaxpr") and hasattr(w, "consts"):
                yield w.jaxpr
            elif type(w).__name__ == "Jaxpr":
                yield w


def dot_flops(jaxpr, mult=1):
    """2 x output elements x contracted size of every dot_general, through
    scan (x its length), cond (its largest branch), pjit, remat and
    custom_vjp / custom_jvp (their primal)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            k = _prod(eqn.invars[0].aval.shape[i] for i in lc)
            total += mult * 2 * _prod(eqn.outvars[0].aval.shape) * k
            continue
        if name == "while":
            raise AssertionError("a while loop has no trip count")
        m = mult * (eqn.params["length"] if name == "scan" else 1)
        subs = list(_subjaxprs(eqn))
        if name == "cond":
            total += max(dot_flops(s, m) for s in subs)
            continue
        if name.startswith("custom_"):
            subs = subs[:1]
        total += sum(dot_flops(s, m) for s in subs)
    return total


def _reference(arch, kind):
    cfg = jconfig(arch).reduced()
    SDS = jax.ShapeDtypeStruct
    params = jax.eval_shape(partial(JM.init_params, cfg),
                            jax.random.PRNGKey(0))
    dt = jnp.dtype(cfg.dtype)
    batch = {}
    if kind != "decode":
        batch["tokens"] = SDS((B, S - cfg.num_image_tokens), jnp.int32)
        if cfg.num_image_tokens:
            batch["image_embeds"] = SDS((B, cfg.num_image_tokens,
                                         cfg.d_model), dt)
        if cfg.is_encoder_decoder:
            batch["enc_frames"] = SDS((B, cfg.encoder_seq_len, cfg.d_model),
                                      dt)
    if kind == "train":
        fn = jtrain_step(cfg, JO.AdamWConfig())
        args = (params, jax.eval_shape(JO.init, params), batch)
    else:
        cache = jax.eval_shape(partial(JM.init_cache, cfg, B, S))
        if kind == "prefill":
            def fn(p, b, c):
                return JM.prefill(cfg, p, b, c)
            args = (params, batch, cache)
        else:
            def fn(p, t, c, pos):
                return JM.decode_step(cfg, p, t, c, pos)
            args = (params, SDS((B,), jnp.int32), cache,
                    SDS((), jnp.int32))
    return dot_flops(jax.make_jaxpr(fn)(*args).jaxpr)


def _port_step(cfg, kind, dev):
    shape = dataclasses.replace(INPUT_SHAPES[KINDS[kind]], seq_len=S,
                                global_batch=B)
    params = specs.params_struct(cfg, device=dev)
    if kind == "train":
        return ptrain_step(cfg, PO.AdamWConfig()), (
            params, PO.init(params), specs.token_struct(cfg, shape,
                                                        device=dev))
    cache = specs.cache_struct(cfg, B, S, device=dev)
    if kind == "prefill":
        return (lambda p, b, c: PM.prefill(cfg, p, b, c),
                (params, specs.token_struct(cfg, shape, device=dev), cache))
    return (lambda p, t, c, pos: PM.decode_step(cfg, p, t, c, pos),
            (params, torch.zeros((B,), dtype=torch.int32, device=dev), cache,
             torch.tensor(S - 1, device=dev)))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_matmul_flops_equal_the_reference_jaxpr(arch, kind):
    want = _reference(arch, kind)
    fn, args = _port_step(pconfig(arch).reduced(), kind, "meta")
    with ops.backend("plain"):
        counter, _, _ = dryrun.count_step(fn, args)
    got = counter.matmul_flops
    assert want > 0
    if arch == "xlstm-125m" and kind in XLSTM_RTOL:
        assert got != want and abs(got - want) <= XLSTM_RTOL[kind] * want
    else:
        assert got == want


@pytest.mark.parametrize("arch,kind", [("llama2-70b", "train"),
                                       ("jamba-v0.1-52b", "prefill"),
                                       ("granite-moe-3b-a800m", "train")])
def test_meta_step_counts_what_the_cpu_counts(arch, kind):
    """Kernel ops by formula, everything else op by op: equal counts on
    the meta device and on the CPU."""
    got = {}
    for dev in ("meta", "cpu"):
        fn, args = _port_step(pconfig(arch).reduced(), kind, dev)
        c, _, _ = dryrun.count_step(fn, args)
        got[dev] = (c.flops, c.matmul_flops, c.bytes, c.exps,
                    {k: tuple(v) for k, v in c.by_op.items()},
                    dict(c.kernels))
    assert got["meta"] == got["cpu"]
    assert got["cpu"][-1]                     # kernel ops were counted
