"""Quantized serving in the port against the JAX package: int8 / fp8 KV
pages (quantize-on-write, the three quantized paged kernels' plain
versions, scatter and copy-on-write of the scale pools, guard layers) and
weight-only int8 (``mm``, ``quantize_params``, the bridge), each held
against repro.models.quant and repro.kernels; then the engines, serving
the same workloads on the same bridged weights (reduced granite-8b, fp32)
with greedy tokens and ServeStats counters identical.

Inputs come from numpy seeds. Kernel checks use atol 2e-5, as
test_torch_kernels.py does; fp8 outputs are compared by tolerance only,
never by bits. Quantization itself must match bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.plan import Assignment, PipelinePlan, StagePlan
from repro.kernels import ref as jref
from repro.kernels.paged_attention import (
    paged_context_attention_quant_pallas, paged_decode_attention_quant_pallas,
    paged_verify_attention_quant_pallas)
from repro.models import model as JM
from repro.models import quant as JQ
from repro.serving import request as jreq
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.loop import VirtualClock as JClock
from repro_torch import bridge
from repro_torch.configs import get_config as port_config
from repro_torch.core import plan as port_plan
from repro_torch.kernels import ops
from repro_torch.models import model as PM
from repro_torch.models import quant as PQ
from repro_torch.serving import request as preq
from repro_torch.serving.engine import InferenceEngine as PEngine
from repro_torch.serving.loop import VirtualClock as PClock

ATOL = 2e-5
KV_DTYPES = ("int8", "fp8")
COUNTERS = ("latencies", "iterations", "prefill_tokens", "prefix_lookups",
            "prefix_hits", "prefix_hit_tokens", "cow_copies", "preemptions",
            "spec_steps", "spec_proposed", "spec_accepted", "spec_tokens",
            "kv_bytes_resident", "kv_bytes_saved")


def _rn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to_torch(a):
    """numpy (ml_dtypes fp8 included) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _bytes(t):
    """torch tensor -> its bytes as a numpy array (exact comparison)."""
    return PQ.bits(t).numpy().view(np.uint8)


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("granite-8b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, port_config("granite-8b").reduced(), tree


# --- quantize_kv_rows: bit-equal to the reference ----------------------------

@pytest.mark.parametrize("kv", KV_DTYPES)
def test_quantize_kv_rows_bit_equal_to_reference(kv):
    rows = _rn(np.random.default_rng(0), 64, 16, 8, 128) * 3.0
    rows[0, 0, 0] = 0.0                        # an all-zero row: scale floor
    jq, js = JQ.quantize_kv_rows(jnp.asarray(rows), kv)
    pq, ps = PQ.quantize_kv_rows(torch.from_numpy(rows), kv)
    assert pq.dtype == PQ.kv_storage_dtype(kv) and ps.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(pq), _bytes(_to_torch(jq)))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    back = PQ.dequantize_kv(pq, ps).numpy()
    np.testing.assert_array_equal(back, np.asarray(JQ.dequantize_kv(jq, js)))
    assert PQ.kv_dtype_name(pq.dtype) == kv and PQ.kv_is_quantized(kv)
    assert PQ.kv_itemsize(kv) == JQ.kv_itemsize(kv) == 1


# --- the quantized kernels' plain versions (scripts/smoke_serving.py:319) ----

def _smoke_inputs(kv):
    """The quant suite's shapes: b 2, hq 4, hkv 2, d 32, 16-token pages,
    12-block pools quantized by the reference; decode, context and verify
    operands (numpy)."""
    rng = np.random.default_rng(7)
    b, hq, hkv, d, bs, nblk = 2, 4, 2, 32, 16, 12
    kq, ks = JQ.quantize_kv_rows(jnp.asarray(_rn(rng, nblk, bs, hkv, d)), kv)
    vq, vs = JQ.quantize_kv_rows(jnp.asarray(_rn(rng, nblk, bs, hkv, d)), kv)
    pools = tuple(np.asarray(x) for x in (kq, vq, ks, vs))
    tbl = np.array([[3, 1, 4, 0], [5, 9, 2, 6]], np.int32)
    i32 = lambda *x: np.array(x, np.int32)              # noqa: E731
    return {
        "decode": (_rn(rng, b, 1, hq, d), dict(kv_len=i32(41, 64))),
        "context": (_rn(rng, b, 8, hq, d),
                    dict(q_start=i32(17, 40), kv_len=i32(25, 45))),
        "verify": (_rn(rng, b, 4, hq, d),
                   dict(kv_start=i32(21, 33), kv_len=i32(25, 35))),
    }, pools, tbl


QUANT_KERNELS = {
    "decode": (paged_decode_attention_quant_pallas,
               jref.paged_decode_attention_quant_ref,
               ops.paged_decode_attention),
    "context": (paged_context_attention_quant_pallas,
                jref.paged_context_attention_quant_ref,
                ops.paged_context_attention),
    "verify": (paged_verify_attention_quant_pallas,
               jref.paged_verify_attention_quant_ref,
               ops.paged_verify_attention),
}


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("kernel", sorted(QUANT_KERNELS))
def test_quant_paged_attention_matches_pallas(kernel, kv):
    """The port's quantized plain versions (what ops runs on CPU tensors)
    against the Pallas kernels in interpret mode and the reference's
    oracles, atol 2e-5."""
    inputs, pools, tbl = _smoke_inputs(kv)
    q, kw = inputs[kernel]
    pallas, oracle, port_entry = QUANT_KERNELS[kernel]
    kq, vq, ks, vs = pools
    jargs = (jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(tbl))
    jkw = {n: jnp.asarray(x) for n, x in kw.items()}
    port = port_entry(torch.from_numpy(q), _to_torch(kq), _to_torch(vq),
                      torch.from_numpy(tbl), k_scale=_to_torch(ks),
                      v_scale=_to_torch(vs),
                      **{n: torch.from_numpy(x) for n, x in kw.items()})
    for what, want in (("Pallas (interpret)",
                        pallas(*jargs, interpret=True, **jkw)),
                       ("repro.kernels.ref", oracle(*jargs, **jkw))):
        err = float(np.abs(port.numpy() - np.asarray(want)).max())
        assert err <= ATOL, f"{kernel} {kv} vs {what}: max abs err {err}"


# --- kernel #6's arithmetic on the card (csrc/paged_attention.cu) -----------
# The bf16 context body widens one-byte pages to bf16 and folds the scales
# in: scores times k_scale per key before the softmax, probabilities times
# v_scale per key before P V, the row sum over the unscaled
# probabilities.

def _folded_context(q, kq, vq, ks, vs, tbl, q_start, kv_len):
    """Context attention on widened pages with the scales folded in, fp32
    (numpy): the kernel's order of operations."""
    b, C, hq, d = q.shape
    _, bs, hkv, _ = kq.shape
    g = hq // hkv
    k = np.asarray(kq).astype(np.float32)[tbl].reshape(b, -1, hkv, d)
    v = np.asarray(vq).astype(np.float32)[tbl].reshape(b, -1, hkv, d)
    kscale = np.asarray(ks)[tbl].reshape(b, -1, hkv)
    vscale = np.asarray(vs)[tbl].reshape(b, -1, hkv)
    S = k.shape[1]
    qh = q.reshape(b, C, hkv, g, d)
    s = np.einsum("bchgd,bjhd->bhgcj", qh, k) / np.sqrt(d)
    s = s * kscale.transpose(0, 2, 1)[:, :, None, None, :]
    qpos = q_start[:, None] + np.arange(C)[None]
    live = (np.arange(S)[None, None] <= qpos[:, :, None]) & \
        (np.arange(S)[None, None] < kv_len[:, None, None])  # (b, C, S)
    live = live[:, None, None]
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.where(live, np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(-1, keepdims=True)
    pw = p * vscale.transpose(0, 2, 1)[:, :, None, None, :]
    o = np.einsum("bhgcj,bjhd->bchgd", pw, v) / np.maximum(l, 1e-30) \
        .transpose(0, 3, 1, 2, 4)
    return o.reshape(b, C, hq, d).astype(np.float32)


@pytest.mark.parametrize("bs", [5, 16])
@pytest.mark.parametrize("kv", KV_DTYPES)
def test_quant_context_folds_scales_into_widened_pages(kv, bs):
    rng = np.random.default_rng(11)
    b, C, hq, hkv, d, nb = 3, 6, 4, 2, 32, 8
    n_blocks = b * nb + 1
    kq, ks = JQ.quantize_kv_rows(
        jnp.asarray(_rn(rng, n_blocks, bs, hkv, d)), kv)
    vq, vs = JQ.quantize_kv_rows(
        jnp.asarray(_rn(rng, n_blocks, bs, hkv, d)), kv)
    pools = tuple(np.asarray(x) for x in (kq, vq, ks, vs))
    tbl = (rng.permutation(n_blocks - 1)[:b * nb] + 1).reshape(b, nb) \
        .astype(np.int32)
    tbl[2] = 0                                # a free slot: exact zeros
    q = _rn(rng, b, C, hq, d)
    # a chunk mid-page past several pages, one ending mid-chunk, a dead row
    q_start = np.array([2 * bs + 3, bs - 1, 0], np.int32)
    kv_len = q_start + np.array([C, 4, 0], np.int32)
    want = _folded_context(q, *pools, tbl, q_start, kv_len)
    assert not np.any(want[2])
    jargs = (jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(tbl))
    jkw = dict(q_start=jnp.asarray(q_start), kv_len=jnp.asarray(kv_len))
    port = ops.paged_context_attention(
        torch.from_numpy(q), _to_torch(pools[0]), _to_torch(pools[1]),
        torch.from_numpy(tbl), k_scale=_to_torch(pools[2]),
        v_scale=_to_torch(pools[3]), q_start=torch.from_numpy(q_start),
        kv_len=torch.from_numpy(kv_len))
    for what, got in (
            ("Pallas (interpret)", paged_context_attention_quant_pallas(
                *jargs, interpret=True, **jkw)),
            ("repro.kernels.ref", jref.paged_context_attention_quant_ref(
                *jargs, **jkw)),
            ("the port's plain version", port.numpy())):
        err = float(np.abs(np.asarray(got) - want).max())
        assert err <= ATOL, f"{kv} bs {bs}: folded vs {what}: {err}"


# --- kernels #5 and #7's arithmetic on the card (csrc/decode.cuh) ------------
# The decode body on quantized pools widens one-byte K/V rows in registers
# and folds the scales in, as #6 does: each score times its key's k_scale
# before the running max, each probability times its key's v_scale before
# P V, the row sum over the unscaled probabilities; a query column (decode:
# a head; verify: a (candidate, head) pair) sees the keys below its limit.

def _folded_columns(q, kq, vq, ks, vs, tbl, lim):
    """Attention of q (b, T, hq, d) on widened pages with the scales folded
    in, candidate t of row i seeing keys [0, lim[i, t]); fp32 (numpy): the
    kernels' order of operations. A column with no key gives zeros."""
    b, T, hq, d = q.shape
    _, bs, hkv, _ = kq.shape
    g = hq // hkv
    k = np.asarray(kq).astype(np.float32)[tbl].reshape(b, -1, hkv, d)
    v = np.asarray(vq).astype(np.float32)[tbl].reshape(b, -1, hkv, d)
    kscale = np.asarray(ks)[tbl].reshape(b, -1, hkv).transpose(0, 2, 1)
    vscale = np.asarray(vs)[tbl].reshape(b, -1, hkv).transpose(0, 2, 1)
    S = k.shape[1]
    s = np.einsum("bthgd,bjhd->bthgj", q.reshape(b, T, hkv, g, d), k)
    s = s * kscale[:, None, :, None, :] / np.sqrt(d)
    live = (np.arange(S)[None, None] < lim[:, :, None])[:, :, None, None]
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.where(live, np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(-1, keepdims=True)
    pw = p * vscale[:, None, :, None, :]
    o = np.einsum("bthgj,bjhd->bthgd", pw, v) / np.maximum(l, 1e-30)
    return o.reshape(b, T, hq, d).astype(np.float32)


def _folded_decode(q, kq, vq, ks, vs, tbl, kv_len):
    """#5: one query per row, every head sees keys [0, kv_len)."""
    return _folded_columns(q, kq, vq, ks, vs, tbl, kv_len[:, None])


def _folded_verify(q, kq, vq, ks, vs, tbl, kv_start, kv_len):
    """#7: candidate t sees keys [0, min(kv_len, kv_start + t + 1))."""
    T = q.shape[1]
    lim = np.minimum(kv_len[:, None], kv_start[:, None] + np.arange(T) + 1)
    return _folded_columns(q, kq, vq, ks, vs, tbl, lim)


def _decode_body_inputs(kv, bs, g, T):
    """4 rows of 48-key (or more) tables at g query heads per kv head (hkv
    2, d 32) on pools quantized by the reference; row 2 a free slot (an
    all-null table, kv_len 0), the null page's scales 0 as in a fresh
    pool."""
    rng = np.random.default_rng(100 * bs + 10 * g + T)
    b, hkv, d = 4, 2, 32
    nb = -(-48 // bs)
    n_blocks = b * nb + 1
    kq, ks = JQ.quantize_kv_rows(
        jnp.asarray(_rn(rng, n_blocks, bs, hkv, d)), kv)
    vq, vs = JQ.quantize_kv_rows(
        jnp.asarray(_rn(rng, n_blocks, bs, hkv, d)), kv)
    ks, vs = (np.asarray(x).copy() for x in (ks, vs))
    ks[0] = vs[0] = 0.0
    pools = (np.asarray(kq), np.asarray(vq), ks, vs)
    tbl = (rng.permutation(n_blocks - 1)[:b * nb] + 1).reshape(b, nb) \
        .astype(np.int32)
    tbl[2] = 0
    return _rn(rng, b, T, g * hkv, d), pools, tbl, nb * bs


def _check_folded(what, want, pallas, oracle, port):
    for name, got in (("Pallas (interpret)", pallas),
                      ("repro.kernels.ref", oracle),
                      ("the port's plain version", port.numpy())):
        err = float(np.abs(np.asarray(got) - want).max())
        assert err <= ATOL, f"{what}: folded vs {name}: {err}"


def _port_args(q, pools, tbl):
    kq, vq, ks, vs = pools
    return ((torch.from_numpy(q), _to_torch(kq), _to_torch(vq),
             torch.from_numpy(tbl)),
            dict(k_scale=_to_torch(ks), v_scale=_to_torch(vs)))


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("bs", [5, 16])
@pytest.mark.parametrize("kv", KV_DTYPES)
def test_quant_decode_folds_scales_into_widened_pages(kv, bs, g):
    q, pools, tbl, cap = _decode_body_inputs(kv, bs, g, 1)
    # a full table, a row ending mid-page, the free slot, a one-key row
    kv_len = np.array([cap, 17, 0, 1], np.int32)
    want = _folded_decode(q, *pools, tbl, kv_len)
    assert not np.any(want[2])
    jargs = (jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(tbl))
    targs, scales = _port_args(q, pools, tbl)
    _check_folded(
        f"decode {kv} bs {bs} g {g}", want,
        paged_decode_attention_quant_pallas(*jargs, kv_len=jnp.asarray(kv_len),
                                            interpret=True),
        jref.paged_decode_attention_quant_ref(*jargs,
                                              kv_len=jnp.asarray(kv_len)),
        ops.paged_decode_attention(*targs, kv_len=torch.from_numpy(kv_len),
                                   **scales))


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("bs", [5, 16])
@pytest.mark.parametrize("kv", KV_DTYPES)
def test_quant_verify_folds_scales_into_widened_pages(kv, bs, g):
    T = 4
    q, pools, tbl, cap = _decode_body_inputs(kv, bs, g, T)
    # a full chunk ending at the table's last key, a chunk with two padding
    # candidates (they see the committed keys), the free slot (exact
    # zeros), and F2's kv_len == kv_start > 0 (every candidate sees the
    # committed keys)
    kv_start = np.array([cap - T, 7, 0, 12], np.int32)
    kv_len = kv_start + np.array([T, 2, 0, 0], np.int32)
    want = _folded_verify(q, *pools, tbl, kv_start, kv_len)
    assert not np.any(want[2]) and np.all(np.any(want[3], axis=(1, 2)))
    jargs = (jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(tbl))
    jkw = dict(kv_start=jnp.asarray(kv_start), kv_len=jnp.asarray(kv_len))
    targs, scales = _port_args(q, pools, tbl)
    _check_folded(
        f"verify {kv} bs {bs} g {g}", want,
        paged_verify_attention_quant_pallas(*jargs, interpret=True, **jkw),
        jref.paged_verify_attention_quant_ref(*jargs, **jkw),
        ops.paged_verify_attention(*targs, kv_start=torch.from_numpy(kv_start),
                                   kv_len=torch.from_numpy(kv_len), **scales))


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_one_byte_codes_widen_to_bf16_exactly(kv):
    """Every int8 code and every finite fp8 e4m3 code is exact in bf16, the
    premise of #6's bf16 tiles: as fp32 its low 16 bits are zero, so the
    kernel's upper-half truncation is its bf16. int8 takes the kernel's
    route: byte x ^ 0x80 as the low byte of f16 1024, minus 1152."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    x = codes.view(PQ.kv_storage_dtype(kv))
    f = x.float()
    if kv == "fp8":
        keep = torch.isfinite(f)
        assert int(keep.sum()) == 254            # 0x7f, 0xff are NaN
        x, f = x[keep], f[keep]
    else:
        bits = ((codes.to(torch.int32) ^ 0x80) | 0x6400).to(torch.int16)
        magic = bits.view(torch.float16) - torch.tensor(1152.0,
                                                         dtype=torch.float16)
        assert magic.dtype == torch.float16 and torch.equal(magic.float(), f)
    assert not torch.any(f.view(torch.int32) & 0xFFFF)
    assert torch.equal(x.to(torch.bfloat16).float(), f)
    assert torch.equal((f.view(torch.int32) >> 16).to(torch.int16)
                       .view(torch.bfloat16), x.to(torch.bfloat16))


# --- pools: scatter, copy-on-write, guard layers (tests/test_paged.py) -------

def _quant_pool(kv, n_blocks, bs, h, d):
    return {"k": torch.zeros((n_blocks, bs, h, d), dtype=PQ.kv_storage_dtype(kv)),
            "v": torch.zeros((n_blocks, bs, h, d), dtype=PQ.kv_storage_dtype(kv)),
            "k_scale": torch.zeros((n_blocks, bs, h)),
            "v_scale": torch.zeros((n_blocks, bs, h))}


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_quant_scatter_rows_matches_reference(kv):
    """scatter_rows_to_pages quantizes on write: the landed payload and
    scales equal the reference's scatter bit for bit, and the untouched
    null page stays zero (test_paged.py:459)."""
    rng = np.random.default_rng(11)
    m, S, h, d, bs = 2, 16, 2, 32, 8
    n_blocks = 1 + m * (S // bs)
    rows = {"k": _rn(rng, m, S, h, d), "v": _rn(rng, m, S, h, d)}
    dest = np.arange(1, n_blocks, dtype=np.int32)
    jpool = {n: jnp.asarray(PQ.bits(t).numpy()).view(
        JQ.kv_storage_dtype(kv)) if n in ("k", "v") else jnp.asarray(t.numpy())
        for n, t in _quant_pool(kv, n_blocks, bs, h, d).items()}
    want = JM.scatter_rows_to_pages(
        jpool, {n: jnp.asarray(r) for n, r in rows.items()},
        jnp.asarray(dest))
    pool = _quant_pool(kv, n_blocks, bs, h, d)
    PM.scatter_rows_to_pages(pool, {n: torch.from_numpy(r)
                                    for n, r in rows.items()},
                             torch.from_numpy(dest))
    for n in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bytes(pool[n]),
                                      _bytes(_to_torch(want[n])), err_msg=n)
    assert not _bytes(pool["k"][0]).any() and not pool["k_scale"][0].any()


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_cow_copies_scales_with_payload(kv):
    """copy_cache_pages duplicates the scale pools with the payload, and a
    later write to the copy leaves the source page as it was
    (test_paged.py:537)."""
    caches = [_quant_pool(kv, 6, 4, 2, 32) for _ in range(2)]
    for c in caches:
        c["k"][2] = torch.full((4, 2, 32), 7.0).to(c["k"].dtype)
        c["v"][2] = torch.full((4, 2, 32), -7.0).to(c["v"].dtype)
        c["k_scale"][2] = 0.25
        c["v_scale"][2] = 0.5
    PM.copy_cache_pages(caches, torch.tensor([2]), torch.tensor([4]))
    for c in caches:
        for n in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(_bytes(c[n][4]), _bytes(c[n][2]))
        c["k_scale"][4] = 9.0
        assert (c["k_scale"][2] == 0.25).all()


@pytest.mark.parametrize("kv", (None, "fp32") + KV_DTYPES)
@pytest.mark.parametrize("guard", [(), (1,)])
def test_pool_layout_and_guard_layers_match_reference(weights, kv, guard):
    """init_layer_paged_cache: the reference's leaves, shapes and dtypes;
    a guard layer keeps model precision and no scale pools
    (test_paged.py:501)."""
    cfg, pcfg, _ = weights
    want = JM.init_layer_paged_cache(cfg, 1, 6, 8, 2, kv_dtype=kv,
                                     kv_guard_layers=guard)
    got = PM.init_layer_paged_cache(pcfg, 1, 6, 8, dtype=torch.float32,
                                    device="cpu", kv_dtype=kv,
                                    kv_guard_layers=guard)
    assert sorted(got) == sorted(want)
    for n, t in got.items():
        assert tuple(t.shape) == want[n].shape
        assert str(t.dtype).split(".")[-1] == want[n].dtype.name
        assert not t.float().any()


# --- weight-only int8 --------------------------------------------------------

def test_quantize_params_and_mm_match_reference(weights):
    """quantize_params gives the reference's int8 payloads and scales bit
    for bit; mm agrees with the reference's to fp32 rounding; int8 weights
    take under 45% of the fp32 tree's bytes."""
    cfg, _, tree = weights
    jq = JQ.quantize_params(jax.tree.map(jnp.asarray, tree), cfg)
    pq = PQ.quantize_params(bridge.params_from_numpy(tree, device="cpu"))
    flat, tdef = jax.tree.flatten(jq)
    pflat, ptdef = jax.tree.flatten(bridge.params_to_numpy(pq))
    assert tdef == ptdef
    for a, b in zip(flat, pflat):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    assert PQ.quant_bytes(pq) == JQ.quant_bytes(jq)
    assert PQ.quant_bytes(pq) < 0.45 * PQ.quant_bytes(
        bridge.params_from_numpy(tree, device="cpu"))
    x = _rn(np.random.default_rng(2), 3, 5, cfg.d_model)
    w = jq["blocks"]["sub0"]["mlp"]["w_up"]
    pw = pq["blocks"]["sub0"]["mlp"]["w_up"]
    want = JQ.mm(jnp.asarray(x), jax.tree.map(lambda t: t[0], w))
    got = PQ.mm(torch.from_numpy(x), {n: t[0] for n, t in pw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    back = PQ.dequantize_leaf({n: t[0] for n, t in pw.items()})
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        JQ.dequantize_leaf(jax.tree.map(lambda t: t[0], w))))


def test_bridge_keeps_quantized_leaves(weights):
    """A quantized JAX tree bridges with int8 payloads and float32 scales
    whatever `dtype` says; float leaves take `dtype`."""
    cfg, _, tree = weights
    jq = jax.tree.map(np.asarray,
                      JQ.quantize_params(jax.tree.map(jnp.asarray, tree), cfg))
    pq = bridge.params_from_numpy(jq, device="cpu", dtype=torch.bfloat16)
    wq = pq["blocks"]["sub0"]["mixer"]["wq"]
    assert PQ.is_quantized(wq) and PQ.is_quantized(pq["lm_head"])
    assert wq["q"].dtype == torch.int8 and wq["s"].dtype == torch.float32
    np.testing.assert_array_equal(
        wq["q"].numpy(), jq["blocks"]["sub0"]["mixer"]["wq"]["q"])
    assert pq["embed"].dtype == torch.bfloat16
    assert pq["final_norm"]["w"].dtype == torch.bfloat16


# --- serving: the engines, token and counter identical -----------------------

def _synth(mod, vocab):
    return mod.synth_workload(rate=40.0, duration=0.25, vocab=vocab,
                              prompt_len=8, prompt_jitter=5, out_len=4,
                              seed=1)


def _shared(mod, vocab):
    return mod.shared_prefix_workload(rate=4.0, duration=2.0, vocab=vocab,
                                      shared_len=24, unique_len=6,
                                      out_len=4, seed=3)


SERVES = {
    # cold joint prefill + decode on int8 pools, one guard layer
    "int8": (_synth, dict(kv_dtype="int8", kv_guard_layers=(1,))),
    # prefix caching + chunked prefill (the context path) on fp8 pools,
    # chosen per replica
    "fp8-prefix": (_shared, dict(kv_dtypes=["fp8"], prefix_caching=True,
                                 prefill_chunk=16)),
    # n-gram speculation (the verify path) on int8 pools
    "int8-ngram": (_synth, dict(kv_dtype="int8", spec_decode=True,
                                spec_k=3)),
    # weight-only int8 with model-precision pools
    "w8": (_synth, dict(quantize=True)),
}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_quantized_serving_token_identical_to_reference(weights, name):
    cfg, pcfg, tree = weights
    make, kw = SERVES[name]
    common = dict(n_slots=4, max_len=48, block_size=8, **kw)
    asg = Assignment([PipelinePlan([StagePlan([0], 1), StagePlan([1], 1)])])
    jreqs = make(jreq, cfg.vocab_size)
    jstats = JEngine(cfg, asg, params=jax.tree.map(jnp.asarray, tree),
                     policy="continuous", cache_layout="paged",
                     **common).serve(jreqs, deadline=120.0, clock=JClock())

    pasg = port_plan.Assignment([port_plan.PipelinePlan(
        [port_plan.StagePlan([0], 1), port_plan.StagePlan([1], 1)])])
    preqs = make(preq, pcfg.vocab_size)
    eng = PEngine(pcfg, pasg, params=bridge.params_from_numpy(tree,
                                                              device="cpu"),
                  device="cpu", cache_layout="paged", **common)
    pstats = eng.serve(preqs, deadline=120.0, clock=PClock())

    assert len(preqs) == len(jreqs) > 0
    for a, b in zip(jreqs, preqs):
        assert a.output is not None and len(a.output) == a.max_new_tokens
        first = next((i for i, (x, y) in enumerate(zip(a.output, b.output))
                      if x != y), None)
        assert list(a.output) == list(b.output), \
            f"request {a.rid}: streams part at token {first}: " \
            f"{list(a.output)} vs {list(b.output)}"
    for c in COUNTERS:
        assert getattr(pstats, c) == getattr(jstats, c), c
    caches = [c for st in eng.replicas[0].paged_caches for c in st]
    if name == "w8":
        assert pstats.kv_bytes_saved == 0
        assert PQ.is_quantized(eng.replicas[0].stages[0].layer_params[0]
                               ["mixer"]["wq"])
    else:
        assert pstats.kv_bytes_saved > 0 and "kv=" in pstats.summary()
        want = {PQ.kv_storage_dtype(kw.get("kv_dtype") or kw["kv_dtypes"][0])}
        if kw.get("kv_guard_layers"):
            want.add(torch.float32)            # the guard layer's pool
        assert {c["k"].dtype for c in caches} == want
    if name == "fp8-prefix":
        assert pstats.prefix_hits > 0
    if name == "int8-ngram":
        assert pstats.spec_steps > 0
