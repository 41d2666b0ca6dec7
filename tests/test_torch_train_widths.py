"""Training at every width the zoo trains, on the CPU.

Activation checkpointing (``models.model.REMAT_TRAIN``, the reference's
jax.checkpoint of each period in _scan_stack): it is on by default, as in
the reference; with it on, loss_fn and every gradient leaf equal
jax.value_and_grad of the reference (llama here, every reduced arch in
test_torch_train_grads*.py); on llama, reduced jamba (a 4-layer period)
and whisper (an encoder, which is not checkpointed) each decoder period is
recomputed once in the backward pass, and the gradients with it on and
off are the same bits. AdamW updated a
chunk of a leaf at a time (which keeps a train step's peak memory to the
moments) gives the whole leaves' bits.

The attention backward at the widths and masks the two remaining
architectures train with, h2o-danube-1.8b (head dim 80, a sliding window)
and paligemma-3b (head dim 256): the plain versions of #1's training
forward and of its backward kernel (``ref.attention_fwd_lse_ref``,
``ref.attention_bwd_ref``), and ``ops.FlashAttentionFn`` on CPU tensors,
against jax.vjp of the reference's flash attention (its FA2 custom VJP at
d 80 and d 256, autodiff of its sliding-window blocks for a window shorter
than the sequence), relative error 1e-5 as in test_torch_train.py."""
import jax
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from _train_grads import _batch, check_arch
from repro.configs import get_config
from repro.kernels import ops as JO
from repro.models import model as JM
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import ops, ref
from repro_torch.models import model as PM


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# --- activation checkpointing ---------------------------------------------

REMAT_ARCHS = ("llama2-70b", "jamba-v0.1-52b", "whisper-base")


def test_remat_is_on_by_default_as_in_the_reference():
    assert PM.REMAT_TRAIN is True and JM.REMAT_TRAIN is True


def test_remat_grads_equal_reference(monkeypatch):
    # llama here; jamba, whisper and the other reduced archs are held to
    # jax.value_and_grad by test_torch_train_grads*.py under the default,
    # REMAT_TRAIN on
    monkeypatch.setattr(PM, "REMAT_TRAIN", True)
    check_arch("llama2-70b")


def _grads(pcfg, batch):
    # the port's seeded weights, the same on every call
    params = PM.init_params(pcfg, 0, device="cpu")
    leaves = [t for t in jax.tree.leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    loss = PM.loss_fn(pcfg, params, batch)
    loss.backward()
    return loss.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_recomputes_each_period_with_the_same_bits(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    pcfg = port_config(arch).reduced()
    batch = _batch(cfg)
    calls = {"layers": 0, "periods": 0}
    sublayer, checkpoint = PM.apply_sublayer_train, \
        torch.utils.checkpoint.checkpoint

    def counted_sublayer(*a, **k):
        calls["layers"] += 1
        return sublayer(*a, **k)

    def counted_checkpoint(*a, **k):
        calls["periods"] += 1
        return checkpoint(*a, **k)
    monkeypatch.setattr(PM, "apply_sublayer_train", counted_sublayer)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        counted_checkpoint)
    out = {}
    for remat in (False, True):
        monkeypatch.setattr(PM, "REMAT_TRAIN", remat)
        calls.update(layers=0, periods=0)
        out[remat] = _grads(pcfg, batch)
        n = pcfg.num_layers
        # one forward, and under remat one recompute of each period in
        # the backward pass
        assert calls == ({"layers": 2 * n, "periods": PM.n_periods(pcfg)}
                         if remat else {"layers": n, "periods": 0}), calls
    (loss_off, g_off), (loss_on, g_on) = out[False], out[True]
    assert torch.equal(loss_on, loss_off)
    assert len(g_on) == len(g_off)
    for a, b in zip(g_on, g_off):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_adamw_a_chunk_at_a_time_gives_the_whole_leafs_bits(monkeypatch):
    # the update is elementwise: chunks of 7 elements (none dividing the
    # leaves) give the bits of whole leaves, params and moments alike
    from repro_torch.training import optimizer as popt
    shapes = {"w": (3, 5, 7), "b": (11,), "e": (13, 4)}
    cfg = popt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    out = {}
    for chunk in (popt.CHUNK, 7):
        monkeypatch.setattr(popt, "CHUNK", chunk)
        rng = np.random.default_rng(4)
        params = {k: torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)) for k, sh in shapes.items()}
        state = popt.init(params)
        for step in range(3):
            g = np.random.default_rng(step)
            grads = {k: torch.from_numpy(g.standard_normal(sh).astype(
                np.float32)) for k, sh in shapes.items()}
            params, state = popt.apply(cfg, grads, state, params)
        out[chunk] = popt.leaves(params) + popt.leaves(state.mu) \
            + popt.leaves(state.nu)
    a, b = out.values()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --- the attention backward at d 80, d 256 and windowed --------------------

ATTN_CASES = {  # b, s, hq, hkv, d, window (causal)
    "d80": (1, 32, 8, 2, 80, 0),
    "d256": (1, 16, 8, 1, 256, 0),
    "window": (2, 32, 4, 2, 16, 8),
    "window-d80": (1, 32, 4, 1, 80, 12),
}


def _attn_inputs(case, seed=0):
    b, s, hq, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                       (b, s, hq, d))]


def _ref_vjp(case, q, k, v, do):
    """The reference's output and gradients: its flash path's FA2 custom
    VJP without a window, autodiff of the sliding-window blocks with one."""
    _, s, _, _, d, window = case
    if window:
        def f(q, k, v):
            return JO.flash_attention(q, k, v, causal=True, window=window,
                                      q_block=8, kv_block=8)
    else:
        def f(q, k, v):
            return JO._fa_full(True, s, s, d ** -0.5, q, k, v, None, None)
    o, vjp = jax.vjp(f, q, k, v)
    return o, vjp(do)


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_training_plain_versions_equal_reference_vjp(name):
    case = ATTN_CASES[name]
    window = case[-1]
    q, k, v, do = _attn_inputs(case)
    o_want, grads_want = _ref_vjp(case, q, k, v, do)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = ref.attention_fwd_lse_ref(*t[:3], causal=True, window=window)
    assert _rel(o, o_want) <= 1e-5
    if not window:
        _, lse_want = JO._fa_fwd_blocks(True, case[1], case[1],
                                        case[4] ** -0.5, q, k, v, None, None)
        assert _rel(lse, np.asarray(lse_want).reshape(lse.shape)) <= 1e-5
    got = ref.attention_bwd_ref(*t[:3], o, lse, t[3], causal=True,
                                window=window)
    for g, w in zip(got, grads_want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_function_at_training_widths_equals_reference_vjp(name):
    case = ATTN_CASES[name]
    q, k, v, do = _attn_inputs(case, seed=1)
    o_want, grads_want = _ref_vjp(case, q, k, v, do)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    ops.reset_launch_counts()
    o = ops.flash_attention(*t, causal=True, window=case[-1])
    got = torch.autograd.grad(o, t, torch.from_numpy(do))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert _rel(o.detach(), o_want) <= 1e-5
    for g, w in zip(got, grads_want):
        assert _rel(g, w) <= 1e-5
