"""MoE's "global" dispatch, the reference's measurement baseline: the
port's _moe_global against repro.models.moe._moe_global on the same
bridged weights and inputs, fp32, within 1e-5 of the largest output, on
both capacity branches (dropless up to T = 8192 tokens, capacity_factor
T k / E above) and with the router's aux loss; and MOE_DISPATCH choosing
between the two dispatches."""
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


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= RTOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_global_dispatch_equals_reference(moe_leaf, shape):
    cfg, pcfg, leaf = moe_leaf
    x = _inputs(cfg, leaf, *SHAPES[shape])
    jleaf = jax.tree.map(jnp.asarray, leaf)
    pleaf = bridge.params_from_numpy(leaf, device="cpu")
    want, want_aux = JMoE._moe_global(jleaf, jnp.asarray(x), cfg,
                                      return_aux=True)
    got, got_aux = PMoE._moe_global(pleaf, torch.from_numpy(x), pcfg,
                                    return_aux=True)
    _close(got, want)
    assert abs(float(got_aux) - float(want_aux)) <= RTOL * abs(
        float(want_aux))
    _close(PMoE._moe_global(pleaf, torch.from_numpy(x), pcfg,
                            return_aux=False), want)


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
