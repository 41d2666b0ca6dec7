"""MoE's "global" dispatch, the reference's measurement baseline: the
port's _moe_global against repro.models.moe._moe_global on the same
bridged weights and inputs, fp32, within 1e-5 of the largest output, on
both capacity branches (dropless up to T = 8192 tokens, capacity_factor
T k / E above) and with the router's aux loss; the same on expert-parallel
shards at TP 2 and 4 (each shard's ``moe_mlp(..., experts=)`` under
"global", summed, and the layer's aux loss on each); and MOE_DISPATCH
choosing between the two dispatches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.models import moe as PMoE

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")
# (b, s): T = 128 (dropless, C = T) and T = 8400 (C = 1.25 T k / E)
SHAPES = {"dropless": (2, 64), "capacity": (2, 4200)}


@pytest.fixture(scope="module", params=ARCHS)
def moe_leaf(request):
    cfg = get_config(request.param).reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    sub = next(v for v in tree["blocks"].values() if "moe" in v)
    leaf = {k: np.ascontiguousarray(v[0]) for k, v in sub["moe"].items()}
    return cfg, port_config(request.param).reduced(), leaf


def _inputs(cfg, leaf, b, s):
    """Seeded activations; above T = 8192 every token leans towards expert
    0, so that it gets more than its capacity and drops some."""
    x = np.random.default_rng(1).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    if b * s > 8192:
        r0 = leaf["router"][:, 0]
        x = (x + 4.0 * r0 / np.linalg.norm(r0) * np.sqrt(cfg.d_model)
             ).astype(np.float32)
        probs = jax.nn.softmax(jnp.asarray(x.reshape(b * s, -1))
                               @ leaf["router"], axis=-1)
        top = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
        cap = int(cfg.capacity_factor * b * s * cfg.top_k / cfg.num_experts)
        assert (top == 0).sum() > cap
    return x


_REF = {}


def _reference(moe_leaf, shape):
    """The reference's _moe_global (output, aux) of the shape's inputs,
    once per architecture and shape."""
    cfg, _, leaf = moe_leaf
    key = (cfg.name, shape)
    if key not in _REF:
        x = _inputs(cfg, leaf, *SHAPES[shape])
        out, aux = JMoE._moe_global(jax.tree.map(jnp.asarray, leaf),
                                    jnp.asarray(x), cfg, return_aux=True)
        _REF[key] = (x, np.asarray(out), float(aux))
    return _REF[key]


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= RTOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_global_dispatch_equals_reference(moe_leaf, shape):
    cfg, pcfg, leaf = moe_leaf
    x, want, want_aux = _reference(moe_leaf, shape)
    pleaf = bridge.params_from_numpy(leaf, device="cpu")
    got, got_aux = PMoE._moe_global(pleaf, torch.from_numpy(x), pcfg,
                                    return_aux=True)
    _close(got, want)
    assert abs(float(got_aux) - want_aux) <= RTOL * abs(want_aux)
    _close(PMoE._moe_global(pleaf, torch.from_numpy(x), pcfg,
                            return_aux=False), want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_global_dispatch_on_expert_shards_sums_to_the_reference(
        moe_leaf, shape, tp, monkeypatch):
    """Each expert-parallel shard routes every token with the whole router
    and ranks over all E experts (the whole layer's capacity and drops),
    filling only its experts' slots: the shards' outputs sum to the
    reference's layer, and each returns the layer's aux loss."""
    cfg, pcfg, leaf = moe_leaf
    x, want, want_aux = _reference(moe_leaf, shape)
    E = pcfg.num_experts
    assert E % tp == 0
    n = E // tp
    monkeypatch.setattr(PMoE, "MOE_DISPATCH", "global")
    total = 0
    for r in range(tp):
        part = {k: (v if k == "router" else v[r * n:(r + 1) * n])
                for k, v in leaf.items()}
        out, aux = PMoE.moe_mlp(bridge.params_from_numpy(part, device="cpu"),
                                torch.from_numpy(x), pcfg, return_aux=True,
                                experts=(r * n, n))
        assert abs(float(aux) - want_aux) <= RTOL * abs(want_aux)
        total = total + out
    _close(total, want)


def test_moe_dispatch_flag_selects_the_path(moe_leaf, monkeypatch):
    cfg, pcfg, leaf = moe_leaf
    x = torch.from_numpy(_inputs(cfg, leaf, 2, 64))
    pleaf = bridge.params_from_numpy(leaf, device="cpu")
    assert PMoE.MOE_DISPATCH == JMoE.MOE_DISPATCH == "grouped"
    grouped = PMoE.moe_mlp(pleaf, x, pcfg)
    torch.testing.assert_close(grouped, PMoE._moe_grouped(
        pleaf, x, pcfg, return_aux=False), rtol=0, atol=0)
    monkeypatch.setattr(PMoE, "MOE_DISPATCH", "global")
    torch.testing.assert_close(PMoE.moe_mlp(pleaf, x, pcfg), PMoE._moe_global(
        pleaf, x, pcfg, return_aux=False), rtol=0, atol=0)
    monkeypatch.setattr(PMoE, "MOE_DISPATCH", "other")
    with pytest.raises(ValueError, match="MOE_DISPATCH"):
        PMoE.moe_mlp(pleaf, x, pcfg)
