"""The encoder-decoder (whisper-base) and VLM (paligemma-3b) families of the
port against the JAX package's, on the CPU, with weights bridged from
repro.models.model.init_params (reduced configs, fp32). The reference
leaves every LayerNorm bias at zero and every norm scale at one, so the
bridged trees get seeded noise on those leaves (both packages take the
same tree): a skipped bias add or a swapped norm would show.

- the registry: both configs equal the reference's, field by field and
  reduced; the port's own ``init_params`` gives the reference's tree
  (encoder subtree, norm biases, cross-attention, no ``lm_head`` under tied
  embeddings); the bridge carries it exactly;
- the model: ``prefill`` (the encoder over stub frames, cross K/V cached;
  the image prefix behind gemma's embedding scale) and several
  ``decode_step``s give the reference's logits within the tolerances of
  tests/test_serving.py:24-50 (2e-4 for prefill, 2e-3 for decode) and its
  greedy tokens exactly;
- the pipeline: ``AsymmetricPipeline.generate(batch_extras=)`` over a
  [1, 1] split gives the reference pipeline's tokens, and its prefill the
  reference's logits;
- the plain versions of #1 and #8 against the reference's Pallas kernels
  in interpret mode and its oracles at the new shapes: non-causal
  cross-attention with sq != skv (1 and 37 queries against whisper's 1500
  frames) and head dim 256 (paligemma's g 8); the contiguous kernels take
  d 256, the paged ones refuse it by name;
- ROADMAP.md F7: ``InferenceEngine.serve`` on either model raises the
  reference's KeyError in both packages (its static batcher passes no
  ``batch_extras``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import model as JM
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro.serving.pipeline import AsymmetricPipeline as JPipe
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as pplan
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import model as PM
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import VirtualClock as PClock
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipe

ARCHS = ("whisper-base", "paligemma-3b")
PREFILL_ATOL, DECODE_ATOL = 2e-4, 2e-3     # tests/test_serving.py:24-50
KERNEL_ATOL = 2e-5                         # tests/test_torch_kernels.py


def _perturb(tree, rng, name=""):
    """Seeded noise on every norm leaf (scale w, bias b) of the tree."""
    if isinstance(tree, dict):       # a norm's leaves keep its name
        return {k: _perturb(v, rng, name if name.startswith(("ln", "final"))
                            else k)
                for k, v in tree.items()}
    if name.startswith(("ln", "final")):
        return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(
            tree.dtype)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference cfg, port cfg, numpy tree, reference params, port
    params) with the norms perturbed."""
    arch = request.param
    cfg, pcfg = get_config(arch).reduced(), port_config(arch).reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    tree = _perturb(tree, np.random.default_rng(11))
    return (arch, cfg, pcfg, tree, jax.tree.map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


# --- the registry and the parameters -----------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    want, got = get_config(arch), port_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    assert got.total_params == want.total_params
    assert got.head_dim_ == want.head_dim_


def test_port_init_params_has_the_reference_tree(model):
    arch, cfg, pcfg, tree, _, _ = model
    mine = bridge.params_to_numpy(PM.init_params(pcfg, 0, device="cpu"))
    want = [(p, a.shape, a.dtype) for p, a in _leaves(tree)]
    got = [(p, a.shape, a.dtype) for p, a in _leaves(mine)]
    assert got == want
    assert "lm_head" not in mine                   # tied embeddings
    if cfg.is_encoder_decoder:
        assert {"encoder"} <= set(mine)
        assert set(mine["blocks"]["sub0"]) == {"ln1", "mixer", "lnx",
                                               "xattn", "ln2", "mlp"}
        assert set(mine["final_norm"]) == {"w", "b"}


def test_norm_leaves_are_perturbed(model):
    # the reference's LayerNorm biases are zero and its scales one: the
    # fixture's tree must differ from that on every norm leaf
    _, cfg, _, tree, _, _ = model
    norms = [(p, a) for p, a in _leaves(tree)
             if any(x.startswith(("ln", "final")) for x in p)]
    assert norms and all(not np.all(a == (1.0 if p[-1] == "w" else 0.0))
                         for p, a in norms)
    if cfg.is_encoder_decoder:
        assert any(p[-1] == "b" for p, _ in norms)


def test_bridge_round_trip_is_exact(model):
    _, _, _, tree, _, pparams = model
    back = bridge.params_to_numpy(pparams)
    for (pa_, a), (pb, b) in zip(_leaves(tree), _leaves(back)):
        assert pa_ == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --- the model ---------------------------------------------------------------

def test_model_prefill_and_decode_match_reference(model):
    arch, cfg, pcfg, _, jparams, pparams = model
    b, s, steps = 2, 9, 4
    batch = _batch(cfg, b, s)
    total = s + cfg.num_image_tokens
    jcache = JM.init_cache(cfg, b, total + steps)
    jl, jcache = JM.prefill(cfg, jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()}, jcache)
    pcache = PM.init_cache(pcfg, b, total + steps, device="cpu")
    pl, pcache = PM.prefill(pcfg, pparams, batch, pcache)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=PREFILL_ATOL,
                               rtol=0)
    if cfg.is_encoder_decoder:                      # the cached cross K/V
        np.testing.assert_allclose(pcache["sub0"]["cross_k"].numpy(),
                                   np.asarray(jcache["sub0"]["cross_k"]),
                                   atol=PREFILL_ATOL, rtol=0)
    for step in range(steps):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(pl.numpy().argmax(-1), tok)
        jl, jcache = JM.decode_step(cfg, jparams, jnp.asarray(tok), jcache,
                                    total + step)
        pl, pcache = PM.decode_step(pcfg, pparams, tok, pcache,
                                    total + step)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=DECODE_ATOL, rtol=0)


def test_per_row_decode_positions_match_reference(model):
    # slot-style (b,) positions through the model's decode step
    arch, cfg, pcfg, _, jparams, pparams = model
    b, s = 2, 6
    batch = _batch(cfg, b, s, seed=3)
    total = s + cfg.num_image_tokens
    jcache = JM.init_cache(cfg, b, total + 2)
    jl, jcache = JM.prefill(cfg, jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()}, jcache)
    pcache = PM.init_cache(pcfg, b, total + 2, device="cpu")
    PM.prefill(pcfg, pparams, batch, pcache)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    pos = np.array([total, total], np.int32)
    jl2, _ = JM.decode_step(cfg, jparams, jnp.asarray(tok), jcache,
                            jnp.asarray(pos))
    pl2, _ = PM.decode_step(pcfg, pparams, tok, pcache, pos)
    np.testing.assert_allclose(pl2.numpy(), np.asarray(jl2),
                               atol=DECODE_ATOL, rtol=0)


# --- the pipeline ------------------------------------------------------------

def test_pipeline_generate_with_extras_matches_reference(model):
    arch, cfg, pcfg, _, jparams, pparams = model
    dev = jax.devices()[0]
    jp = JPipe(cfg, jparams, [1, 1], [[dev], [dev]])
    pp = PPipe(pcfg, pparams, [1, 1], device="cpu")
    b, s, new = 3, 8, 6
    batch = _batch(cfg, b, s, seed=5)
    toks = batch.pop("tokens")
    np.testing.assert_allclose(
        pp.prefill(toks, max_new=new, batch_extras=batch),
        jp.prefill(toks, max_new=new, batch_extras={
            k: jnp.asarray(v) for k, v in batch.items()}),
        atol=PREFILL_ATOL, rtol=0)
    want = jp.generate(toks, max_new=new, batch_extras={
        k: jnp.asarray(v) for k, v in batch.items()})
    got = pp.generate(toks, max_new=new, batch_extras=batch)
    assert got.shape == want.shape == (b, new)
    np.testing.assert_array_equal(got, want)


def test_pipeline_without_extras_raises_keyerror_as_reference(model):
    arch, cfg, pcfg, _, jparams, pparams = model
    toks = _batch(cfg, 2, 5)["tokens"]
    missing = "enc_frames" if cfg.is_encoder_decoder else "image_embeds"
    dev = jax.devices()[0]
    with pytest.raises(KeyError, match=missing):
        JPipe(cfg, jparams, [2], [[dev]]).generate(toks, max_new=2)
    with pytest.raises(KeyError, match=missing):
        PPipe(pcfg, pparams, [2], device="cpu").generate(toks, max_new=2)


# --- ROADMAP.md F7: the engines cannot serve either model ------------------

def test_engine_serve_raises_keyerror_in_both_packages(model):
    """F7 (a fault of the reference, not fixed): both models fall back to
    static batching (no slot mode), and the static batcher calls
    ``generate`` without ``batch_extras``, so the first batch raises
    KeyError on the missing modality input. The port does the same."""
    arch, cfg, pcfg, _, jparams, pparams = model
    missing = "enc_frames" if cfg.is_encoder_decoder else "image_embeds"
    asg = Assignment([PipelinePlan([StagePlan([0], 1), StagePlan([1], 1)])])
    pasg = pplan.Assignment([pplan.PipelinePlan(
        [pplan.StagePlan([0], 1), pplan.StagePlan([1], 1)])])

    def wl(mod):
        return mod.synth_workload(rate=8.0, duration=0.5,
                                  vocab=cfg.vocab_size, prompt_len=6,
                                  prompt_jitter=2, out_len=3, seed=1)
    with pytest.warns(UserWarning, match="static"):
        jeng = JEngine(cfg, asg, params=jparams, max_len=64)
    with pytest.warns(UserWarning, match="static"):
        peng = PEngine(pcfg, pasg, params=pparams, device="cpu", max_len=64)
    assert [type(w).__name__ for w in peng.router.workers] \
        == [type(w).__name__ for w in jeng.router.workers] \
        == ["StaticBatcher"]
    with pytest.raises(KeyError, match=missing):
        jeng.serve(wl(jreq), deadline=60.0, clock=JClock())
    with pytest.raises(KeyError, match=missing):
        peng.serve(wl(preq), deadline=60.0, clock=PClock())


# --- #1 and #8 at the new shapes ---------------------------------------------

def _rn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, what):
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= KERNEL_ATOL, f"{what}: max abs err {err}"


@pytest.mark.parametrize("sq", [1, 37])
def test_cross_attention_shapes_match_pallas(sq):
    # whisper: g 1, d 64, sq queries (1 at decode, a prompt at prefill)
    # against the encoder's 1500 frames, non-causal
    rng = np.random.default_rng(sq)
    b, h, d, skv = 2, 2, 64, 1500
    q, k, v = _rn(rng, b, sq, h, d), _rn(rng, b, skv, h, d), \
        _rn(rng, b, skv, h, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    _close(got, flash_attention_pallas(jq, jk, jv, causal=False,
                                       kv_block=500, interpret=True),
           "vs Pallas (interpret)")
    _close(got, jref.attention_ref(jq, jk, jv, causal=False),
           "vs repro.kernels.ref")


FLASH256 = {
    "causal": dict(causal=True),
    "kv_len+kv_start": dict(causal=True, kv_len=[23, 37], kv_start=[0, 4]),
    "dead-rows": dict(causal=True, kv_start=[20, 0]),
}


@pytest.mark.parametrize("case", sorted(FLASH256))
def test_flash_attention_at_head_dim_256_matches_pallas(case):
    # paligemma: hq 8 on one kv head of 256
    rng = np.random.default_rng(2)
    b, s, d = 2, 37, 256
    q, k, v = _rn(rng, b, s, 8, d), _rn(rng, b, s, 1, d), _rn(rng, b, s, 1, d)
    kw = FLASH256[case]
    jkw = {n: jnp.asarray(np.asarray(x, np.int32)) if n != "causal" else x
           for n, x in kw.items()}
    tkw = {n: torch.tensor(x, dtype=torch.int32) if n != "causal" else x
           for n, x in kw.items()}
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    _close(got, flash_attention_pallas(jq, jk, jv, interpret=True, **jkw),
           "vs Pallas (interpret)")
    _close(got, jref.attention_ref(jq, jk, jv, **jkw), "vs repro.kernels.ref")
    if case == "dead-rows":
        assert torch.count_nonzero(got[0, :20]) == 0


def test_decode_attention_at_head_dim_256_matches_pallas():
    rng = np.random.default_rng(4)
    b, S, d = 3, 40, 256
    q, k, v = _rn(rng, b, 1, 8, d), _rn(rng, b, S, 1, d), _rn(rng, b, S, 1, d)
    lens = np.array([40, 17, 1], np.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    got = ops.decode_attention(*map(torch.from_numpy, (q, k, v)),
                               kv_len=torch.from_numpy(lens))
    _close(got, decode_attention_pallas(*jargs, kv_len=jnp.asarray(lens),
                                        interpret=True),
           "vs Pallas (interpret)")
    _close(got, jref.decode_attention_ref(*jargs, kv_len=jnp.asarray(lens)),
           "vs repro.kernels.ref")


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_contiguous_kernels_take_head_dim_256(name):
    # the head dim passes the input check; a CPU tensor then fails the
    # device check, so nothing is computed here
    q, k = torch.zeros(1, 1, 8, 256), torch.zeros(1, 8, 1, 256)
    fn = {"flash_attention": fa.flash_attention_cuda,
          "decode_attention": da.decode_attention_cuda}[name]
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, k, k)


@pytest.mark.parametrize("name", ["paged_decode_attention",
                                  "paged_context_attention"])
def test_paged_kernels_refuse_head_dim_256_by_name(name):
    q = torch.zeros(1, 1, 8, 256)
    k = torch.zeros(2, 8, 1, 256)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    fn = {"paged_decode_attention": lambda: pa.paged_decode_attention_cuda(
              q, k, k, tbl, kv_len=[1]),
          "paged_context_attention": lambda: pa.paged_context_attention_cuda(
              q, k, k, tbl, q_start=[0], kv_len=[1])}[name]
    with pytest.raises(ValueError, match=rf"{name}\b.*256"):
        fn()
