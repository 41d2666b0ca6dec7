"""The port's layers and its paged pipeline, with weights bridged from
repro.models.model.init_params, against the JAX package on the same inputs
(fp32, reduced llama2-70b: 2 layers, d_model 256, 4/2 heads).

The pipeline check drives both AsymmetricPipelines, split [1, 1] into two
stages with pools of different sizes, through the same block tables:
joint prefill, chunked context prefill, copy-on-write and decode steps
(with a free slot on an all-null table). Logits must agree within
atol = rtol = 1e-4 at every step (float32 sums run in another order in the
two frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.pipeline import AsymmetricPipeline as JPipeline
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.serving.pipeline import AsymmetricPipeline as PPipeline

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("llama2-70b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, port_config("llama2-70b").reduced(), tree


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_port_config_matches_reference():
    for name in ("llama2-70b", "granite-8b"):
        assert port_config(name).reduced().__dict__ == \
            get_config(name).reduced().__dict__
        assert port_config(name).total_params == get_config(name).total_params


def test_norm_rope_mlp_match(setup):
    cfg, pcfg, tree = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(cfg.d_model).astype(np.float32)
    np.testing.assert_allclose(
        PL.rms_norm(_t(x), _t(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=1e-5)
    h = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(30, 37)]).astype(np.int32)
    np.testing.assert_allclose(
        PL.rope(_t(h), _t(pos).long(), cfg.rope_theta).numpy(),
        np.asarray(JL.rope(jnp.asarray(h), jnp.asarray(pos),
                           cfg.rope_theta)), **TOL)
    lp = jax.tree.map(lambda a: a[0], tree["blocks"]["sub0"])
    np.testing.assert_allclose(
        PL.mlp(bridge.params_from_numpy(lp["mlp"], device="cpu"), _t(x),
               pcfg).numpy(),
        np.asarray(JL.mlp(jax.tree.map(jnp.asarray, lp["mlp"]),
                          jnp.asarray(x), cfg)), **TOL)


def test_attn_prefill_matches(setup):
    cfg, pcfg, tree = setup
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((2, 19, cfg.d_model))).astype(np.float32)
    pos = np.broadcast_to(np.arange(19), (2, 19)).astype(np.int32)
    lp = jax.tree.map(lambda a: a[1], tree["blocks"]["sub0"])["mixer"]
    want, _ = JL.attn_prefill(jax.tree.map(jnp.asarray, lp), jnp.asarray(x),
                              cfg, positions=jnp.asarray(pos))
    got, k, v = PL.attn_prefill(bridge.params_from_numpy(lp, device="cpu"),
                                _t(x), pcfg, positions=_t(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert k.shape == (2, 19, cfg.num_kv_heads, cfg.head_dim_) == v.shape


def _table(rows, max_blocks):
    out = np.zeros((len(rows), max_blocks), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def test_paged_pipeline_calls_match(setup):
    cfg, pcfg, tree = setup
    rng = np.random.default_rng(2)
    V = cfg.vocab_size
    n_slots, max_len, bs = 4, 32, 8
    mb = max_len // bs
    jp = JPipeline(cfg, jax.tree.map(jnp.asarray, tree), [1, 1],
                   [[jax.devices()[0]], [jax.devices()[0]]])
    pp = PPipeline(pcfg, bridge.params_from_numpy(tree, device="cpu"),
                   [1, 1], device="cpu")
    for p in (jp, pp):
        p.init_paged_caches(n_slots, max_len, block_size=bs,
                            stage_blocks=[17, 13])

    def check(step, a, b):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   err_msg=step, **TOL)

    # per-stage physical blocks of each slot (stage pools differ in size)
    blocks = [{0: [3, 5], 2: [1, 9], 1: [6, 8, 11]},
              {0: [2, 7], 2: [4, 10], 1: [5, 6, 12]}]

    # 1. cold joint prefill of slots 0 and 2; row 2 is shape padding
    lens = np.array([11, 6, 1], np.int32)
    toks = np.zeros((3, 16), np.int32)
    for r in range(2):
        toks[r, :lens[r]] = rng.integers(0, V, lens[r])
    dest = [_table([blocks[s][0], blocks[s][2]], mb).reshape(-1)
            for s in range(2)]
    check("insert", jp.insert_slots_paged(toks, lens, [0, 2], dest),
          pp.insert_slots_paged(toks, lens, [0, 2], dest))

    # 2. slot 1's 20-token prompt in two context chunks (padded to 16)
    prompt = rng.integers(0, V, 20).astype(np.int32)
    tables = [_table([blocks[s][1]], mb) for s in range(2)]
    for start, n in ((0, 12), (12, 8)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = prompt[start:start + n]
        args = (toks, np.array([n], np.int32), np.array([start], np.int32),
                tables)
        check(f"context@{start}", jp.context_slots_paged(*args),
              pp.context_slots_paged(*args))

    # 3. copy-on-write: slot 0's first page moves to a fresh block
    for p in (jp, pp):
        p.copy_pages(0, [3], [14])
    blocks[0][0] = [14, 5]

    # 4. decode steps over all slots; slot 3 is free (all-null table)
    pos = np.array([11, 20, 6, 0], np.int32)
    tables = [_table([blocks[s][0], blocks[s][1], blocks[s][2], []], mb)
              for s in range(2)]
    for step in range(4):
        toks = rng.integers(0, V, n_slots).astype(np.int32)
        a = jp.decode_slots_paged(toks, pos, tables)
        b = pp.decode_slots_paged(toks, pos, tables)
        check(f"decode {step}", a[:3], b[:3])
        assert np.isfinite(b).all()
        pos[:3] += 1
