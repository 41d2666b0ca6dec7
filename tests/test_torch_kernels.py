"""The port's attention kernels, through the path CPU tensors take (their
plain PyTorch versions, which the CUDA kernels are held against on the
card), against the JAX package's Pallas kernels in interpret mode and its
ref.py oracles. Same inputs, made with numpy from a seed; fp32,
atol 2e-5 (the serving smoke's kernel tolerance)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import (paged_context_attention_pallas,
                                           paged_decode_attention_pallas)
from repro_torch.kernels import ops

ATOL = 2e-5


def _rn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, want, what):
    want = np.asarray(want)
    err = float(np.abs(port.numpy() - want).max())
    assert err <= ATOL, f"{what}: max abs err {err}"


def _both(jax_fn, port_fn, oracle_fn):
    port = port_fn()
    _close(port, jax_fn(), "vs Pallas (interpret)")
    _close(port, oracle_fn(), "vs repro.kernels.ref")
    return port


# --- flash attention --------------------------------------------------------

FLASH_CASES = {
    # sq not a multiple of 16, causal only
    "causal": dict(causal=True),
    # window, ragged kv_len and a left kv_start on one row
    "window+kv_len+kv_start": dict(causal=True, window=7,
                                   kv_len=[23, 37], kv_start=[0, 4]),
    # kv_start past the first queries of row 0: those rows see no key
    "dead-rows": dict(causal=True, kv_start=[20, 0]),
    "noncausal+kv_len": dict(causal=False, kv_len=[11, 37]),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (4, 1, 64),
                                      (16, 2, 128)])  # g 8, as served
def test_flash_attention_matches_pallas(case, hq, hkv, d):
    rng = np.random.default_rng(0)
    b, s = 2, 37
    q, k, v = _rn(rng, b, s, hq, d), _rn(rng, b, s, hkv, d), \
        _rn(rng, b, s, hkv, d)
    kw = dict(FLASH_CASES[case])
    jkw = {n: (jnp.asarray(np.asarray(x, np.int32))
               if n in ("kv_len", "kv_start") else x) for n, x in kw.items()}
    tkw = {n: (torch.tensor(x, dtype=torch.int32)
               if n in ("kv_len", "kv_start") else x) for n, x in kw.items()}
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out = _both(
        lambda: flash_attention_pallas(jq, jk, jv, interpret=True, **jkw),
        lambda: ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **tkw),
        lambda: jref.attention_ref(jq, jk, jv, **jkw))
    if case == "dead-rows":
        # queries 0..19 of row 0 see no key at all: exact zeros
        assert torch.count_nonzero(out[0, :20]) == 0


# --- paged decode -------------------------------------------------------------

def _pool_and_tables(rng, b, nb, n_blocks, bs, hkv, d):
    kp, vp = _rn(rng, n_blocks, bs, hkv, d), _rn(rng, n_blocks, bs, hkv, d)
    perm = rng.permutation(np.arange(1, n_blocks))[:b * nb]
    return kp, vp, perm.reshape(b, nb).astype(np.int32)


# block sizes: the CPU widths' 8, the engines' 16, and 2 and 12 (no
# multiple of 16: the kernel looks each key up); widths: the CPU tests',
# g 8 as served (llama) and g 4 (Jamba's)
@pytest.mark.parametrize("bs", [2, 8, 12, 16])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (8, 2, 64), (16, 2, 128),
                                      (8, 2, 128)])
def test_paged_decode_matches_pallas(bs, hq, hkv, d):
    rng = np.random.default_rng(1)
    b, nb = 4, 5
    kp, vp, bt = _pool_and_tables(rng, b, nb, 24, bs, hkv, d)
    bt[2] = 0                            # a free slot: all-null table
    kv_len = np.array([1, bs + 3, 1, nb * bs], np.int32)   # ragged + full
    q = _rn(rng, b, 1, hq, d)
    jargs = tuple(map(jnp.asarray, (q, kp, vp, bt)))
    _both(lambda: paged_decode_attention_pallas(
              *jargs, kv_len=jnp.asarray(kv_len), interpret=True),
          lambda: ops.paged_decode_attention(
              *map(torch.from_numpy, (q, kp, vp, bt)),
              kv_len=torch.from_numpy(kv_len)),
          lambda: jref.paged_decode_attention_ref(
              *jargs, kv_len=jnp.asarray(kv_len)))


# --- paged context --------------------------------------------------------------

CONTEXT_CASES = {
    # chunk starts at a page boundary, mid-page, and at 0 with a short
    # real length (padding queries past it still see keys)
    "boundary+midpage+short": ([16, 13, 0], [16 + 9, 13 + 9, 3]),
    # a row with nothing live: every query is dead and must give zeros
    "dead-row": ([8, 0, 5], [8 + 9, 0, 5 + 2]),
    # chunks that start past several pages (mid-page) and end mid-page
    "past-pages+midpage": ([19, 24, 2], [19 + 9, 24 + 6, 2 + 9]),
}


@pytest.mark.parametrize("case", sorted(CONTEXT_CASES))
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (4, 1, 64),
                                      (16, 2, 128)])  # g 8, as served
def test_paged_context_matches_pallas(case, hq, hkv, d):
    rng = np.random.default_rng(2)
    b, nb, bs, C = 3, 4, 8, 9
    kp, vp, bt = _pool_and_tables(rng, b, nb, 16, bs, hkv, d)
    q_start, kv_len = (np.asarray(x, np.int32) for x in CONTEXT_CASES[case])
    q = _rn(rng, b, C, hq, d)
    jargs = tuple(map(jnp.asarray, (q, kp, vp, bt)))
    jkw = dict(q_start=jnp.asarray(q_start), kv_len=jnp.asarray(kv_len))
    out = _both(lambda: paged_context_attention_pallas(*jargs, interpret=True,
                                                       **jkw),
                lambda: ops.paged_context_attention(
                    *map(torch.from_numpy, (q, kp, vp, bt)),
                    q_start=torch.from_numpy(q_start),
                    kv_len=torch.from_numpy(kv_len)),
                lambda: jref.paged_context_attention_ref(*jargs, **jkw))
    if case == "dead-row":
        assert torch.count_nonzero(out[1]) == 0


def test_plain_backend_switch_restores_on_error():
    with pytest.raises(RuntimeError):
        with ops.backend("plain"):
            raise RuntimeError("boom")
    assert ops._BACKEND == "kernel"
