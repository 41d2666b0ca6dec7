"""The port's training path against the JAX package on the CPU: the
synthetic data stream, AdamW, the npz checkpoints (each package restores
the other's), the plain versions of the two backward kernels and the
autograd Functions around them (against jax.vjp of the reference's custom
VJPs), ten train steps of granite-8b reduced, and the training launcher.
The whole-model gradients of every reduced architecture are in
test_torch_train_grads.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config
from repro.kernels import ops as JO
from repro.models import model as JM
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import SyntheticStream as JStream
from repro.training.train_step import make_train_step as j_make_step
from repro_torch import bridge
from repro_torch.checkpoint import ckpt as pckpt
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as ptrain
from repro_torch.training import optimizer as popt
from repro_torch.training.data import DataConfig, SyntheticStream
from repro_torch.training.train_step import make_train_step


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# --- (a) the data stream ---------------------------------------------------

@pytest.mark.parametrize("seed,vocab,states", [(0, 1024, 64), (7, 50, 64),
                                               (3, 32000, 16)])
def test_synthetic_stream_batches_equal(seed, vocab, states):
    want = JStream(JDataConfig(vocab, 24, 3, seed=seed, markov_states=states))
    got = SyntheticStream(DataConfig(vocab, 24, 3, seed=seed,
                                     markov_states=states))
    for step in (0, 1, 5, 1000):
        assert np.array_equal(got.batch(step)["tokens"],
                              want.batch(step)["tokens"])


# --- (b) AdamW --------------------------------------------------------------

def _opt_tree(rng, dtype=np.float32):
    return {"embed": rng.standard_normal((12, 8)).astype(dtype),
            "final_norm": {"w": rng.standard_normal(8).astype(dtype)},
            "blocks": {"sub0": {"ln1": {"w": rng.standard_normal(
                (2, 8)).astype(dtype)},
                "w": rng.standard_normal((2, 8, 6)).astype(dtype)}}}


@pytest.mark.parametrize("step,grad_scale", [(0, 0.01), (0, 10.0), (3, 1.0),
                                             (150, 0.3), (9999, 5.0)])
def test_adamw_apply_equals_reference(step, grad_scale):
    rng = np.random.default_rng(step)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    grads = jax.tree.map(lambda g: g * grad_scale, grads)
    mu = jax.tree.map(lambda p: 0.1 * rng.standard_normal(p.shape)
                      .astype(np.float32), params)
    nu = jax.tree.map(lambda p: 0.01 * rng.random(p.shape)
                      .astype(np.float32), params)
    cfg = dict(lr=1e-3, warmup_steps=100, total_steps=1000)
    jstate = jopt.AdamWState(step=jnp.asarray(step, jnp.int32), mu=mu, nu=nu)
    jp, js = jopt.apply(jopt.AdamWConfig(**cfg),
                        jax.tree.map(jnp.asarray, grads), jstate,
                        jax.tree.map(jnp.asarray, params))
    pstate = bridge.adamw_state_from_numpy(jstate, device="cpu")
    pp, ps = popt.apply(popt.AdamWConfig(**cfg),
                        bridge.params_from_numpy(grads, device="cpu"),
                        pstate, bridge.params_from_numpy(params,
                                                         device="cpu"))
    back = bridge.adamw_state_to_numpy(ps)
    assert int(back.step) == int(js.step) == step + 1
    for got, want in ((bridge.params_to_numpy(pp), jp), (back.mu, js.mu),
                      (back.nu, js.nu)):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert _rel(g, w) <= 1e-6


def test_adamw_lr_schedule_equals_reference():
    cfg = dict(lr=3e-4, warmup_steps=20, total_steps=200, min_lr_frac=0.1)
    for step in (0, 1, 19, 20, 21, 100, 199, 200, 500):
        want = float(jopt.lr_at(jopt.AdamWConfig(**cfg),
                                jnp.asarray(step, jnp.int32)))
        got = float(popt.lr_at(popt.AdamWConfig(**cfg),
                               torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12)


def test_adamw_init_and_bf16_leaves():
    rng = np.random.default_rng(1)
    params = bridge.params_from_numpy(_opt_tree(rng), device="cpu",
                                      dtype=torch.bfloat16)
    state = popt.init(params)
    assert int(state.step) == 0
    assert all(m.dtype == torch.float32 and not m.any()
               for m in popt.leaves(state.mu))
    grads = popt.tree_map(torch.ones_like, params)
    before = [p.clone() for p in popt.leaves(params)]
    new, state = popt.apply(popt.AdamWConfig(lr=0.05, warmup_steps=1),
                            grads, state, params)
    assert int(state.step) == 1
    assert all(p.dtype == torch.bfloat16 for p in popt.leaves(new))
    assert any(not torch.equal(a, b) for a, b in zip(before,
                                                     popt.leaves(new)))


# --- (c) checkpoints --------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite-8b").reduced()
    return cfg, jax.tree.map(np.asarray,
                             JM.init_params(cfg, jax.random.PRNGKey(0)))


def _opt_like(params, step):
    rng = np.random.default_rng(step)
    return jopt.AdamWState(
        step=jnp.asarray(step, jnp.int32),
        mu=jax.tree.map(lambda p: rng.standard_normal(p.shape)
                        .astype(np.float32), params),
        nu=jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                        params))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_restore(granite, tmp_path, writer, dtype):
    _, params = granite
    jparams = jax.tree.map(lambda p: jnp.asarray(p, dtype), params)
    jstate = _opt_like(params, 7)
    tdt = getattr(torch, dtype)
    pparams = bridge.params_from_numpy(params, device="cpu", dtype=tdt)
    pstate = bridge.adamw_state_from_numpy(jstate, device="cpu")
    if writer == "jax":
        jckpt.save(str(tmp_path), 7, jparams, jstate)
        got_p, got_s, meta = pckpt.restore(
            str(tmp_path), pckpt.latest_step(str(tmp_path)), pparams,
            pstate)
        got_p = bridge.params_to_numpy(got_p)
        got_s = bridge.adamw_state_to_numpy(got_s)
        assert all(t.dtype == tdt for t in popt.leaves(
            pckpt.restore(str(tmp_path), 7, pparams)[0]))
    else:
        pckpt.save(str(tmp_path), 7, pparams, pstate)
        got_p, got_s, meta = jckpt.restore(
            str(tmp_path), jckpt.latest_step(str(tmp_path)), jparams,
            jstate)
        assert all(x.dtype == jnp.dtype(dtype)
                   for x in jax.tree.leaves(got_p))
    assert meta["step"] == 7
    want_p = jax.tree.map(lambda p: np.asarray(p, np.float32), jparams)
    assert jax.tree.structure(jax.tree.map(np.asarray, got_p)) == \
        jax.tree.structure(want_p)
    for g, w in zip(jax.tree.leaves(got_p), jax.tree.leaves(want_p)):
        assert g.shape == w.shape
        assert np.array_equal(np.asarray(g, np.float32), w)
    assert int(got_s.step) == 7
    for g, w in zip(jax.tree.leaves((got_s.mu, got_s.nu)),
                    jax.tree.leaves((jstate.mu, jstate.nu))):
        assert np.array_equal(np.asarray(g), w)


def test_checkpoint_keys_equal_reference(granite, tmp_path):
    _, params = granite
    state = _opt_like(params, 3)
    jckpt.save(str(tmp_path / "j"), 3, params, state)
    pckpt.save(str(tmp_path / "p"), 3,
               bridge.params_from_numpy(params, device="cpu"),
               bridge.adamw_state_from_numpy(state, device="cpu"))
    for f in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "j" / "step_00000003" / f) as a, \
                np.load(tmp_path / "p" / "step_00000003" / f) as b:
            assert sorted(a.files) == sorted(b.files)
            assert "step" in a.files or f == "params.npz"
            for k in a.files:
                assert a[k].shape == b[k].shape, k
    assert pckpt.latest_step(str(tmp_path / "p")) == 3
    assert pckpt.latest_step(str(tmp_path / "missing")) is None


# --- (d) the backward kernels' plain versions and the Functions -----------

ATTN_CASES = [  # b, sq, skv, hq, hkv, d, causal
    (2, 16, 16, 4, 2, 8, True), (2, 16, 16, 4, 2, 8, False),
    (1, 32, 32, 8, 1, 16, True), (2, 12, 20, 4, 4, 8, False),
    (1, 24, 24, 6, 3, 16, True)]


def _attn_inputs(case, seed=0):
    b, sq, skv, hq, hkv, d, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                       (b, sq, hq, d))]


def _attn_vjp(case, q, k, v, do):
    _, sq, skv, _, _, d, causal = case
    f = lambda q, k, v: JO._fa_full(causal, sq, skv, d ** -0.5, q, k, v,
                                    None, None)
    o, vjp = jax.vjp(f, q, k, v)
    return o, vjp(do)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bwd_ref_equals_reference_vjp(case):
    q, k, v, do = _attn_inputs(case)
    o_want, grads_want = _attn_vjp(case, q, k, v, do)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = ref.attention_fwd_lse_ref(*t[:3], causal=case[-1])
    _, lse_want = JO._fa_fwd_blocks(case[-1], case[1], case[2],
                                    case[5] ** -0.5, q, k, v, None, None)
    assert _rel(o, o_want) <= 1e-5
    assert _rel(lse, np.asarray(lse_want).reshape(lse.shape)) <= 1e-5
    got = ref.attention_bwd_ref(*t[:3], o, lse, t[3], causal=case[-1])
    for g, w in zip(got, grads_want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_function_on_cpu_equals_reference_vjp(case):
    q, k, v, do = _attn_inputs(case, seed=1)
    o_want, grads_want = _attn_vjp(case, q, k, v, do)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    ops.reset_launch_counts()
    o = ops.flash_attention(*t, causal=case[-1])
    got = torch.autograd.grad(o, t, torch.from_numpy(do))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert _rel(o.detach(), o_want) <= 1e-5
    for g, w in zip(got, grads_want):
        assert _rel(g, w) <= 1e-5


def test_attention_function_window_and_masks_on_cpu():
    # a window that covers every key is dropped, as the reference drops
    # it; kv_len / kv_start masks reach both passes of the plain versions
    q, k, v, do = _attn_inputs((2, 16, 16, 4, 2, 8, True), seed=2)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*t, window=64)
    got = torch.autograd.grad(o, t, torch.from_numpy(do))
    _, want = _attn_vjp((2, 16, 16, 4, 2, 8, True), q, k, v, do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    lens, starts = torch.tensor([16, 9]), torch.tensor([0, 3])

    def plain(q, k, v):
        return ref.attention_ref(q, k, v, kv_len=lens, kv_start=starts)
    o = ops.flash_attention(*t, kv_len=lens, kv_start=starts)
    got = torch.autograd.grad(o, t, torch.from_numpy(do))
    want = torch.autograd.grad(plain(*t), t, torch.from_numpy(do))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


def _scan_inputs(b, s, din, ds, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.standard_normal((b, s, din)).astype(f),
                dt=(0.1 * rng.random((b, s, din))).astype(f),
                A=-np.exp(rng.standard_normal((din, ds))).astype(f),
                B=rng.standard_normal((b, s, ds)).astype(f),
                C=rng.standard_normal((b, s, ds)).astype(f),
                D=rng.standard_normal(din).astype(f),
                h0=rng.standard_normal((b, din, ds)).astype(f),
                dy=rng.standard_normal((b, s, din)).astype(f),
                dh=rng.standard_normal((b, din, ds)).astype(f))


def _scan_vjp(x, with_h0, with_dh):
    names = ("x", "dt", "A", "B", "C", "D", "h0")

    def f(x_, dt, A, B, C, D, h0):
        return JO._ssm_scan_xla(x_, dt, A, B, C, D,
                                h0=h0 if with_h0 else None, chunk=128)
    (y, h), vjp = jax.vjp(f, *(x[n] for n in names))
    dh = x["dh"] if with_dh else np.zeros_like(x["dh"])
    return y, h, vjp((x["dy"], dh))


SCAN_CASES = [  # b, s, din, ds, h0, dh
    (2, 16, 8, 4, True, True), (2, 300, 8, 4, True, False),
    (1, 129, 24, 16, False, True), (2, 40, 12, 8, False, False)]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssm_scan_bwd_ref_equals_reference_vjp(case):
    b, s, din, ds, with_h0, with_dh = case
    x = _scan_inputs(b, s, din, ds)
    y_want, h_want, grads_want = _scan_vjp(x, with_h0, with_dh)
    t = {n: torch.from_numpy(v) for n, v in x.items()}
    h0 = t["h0"] if with_h0 else None
    y, h, h_ins = ref.ssm_scan_states_ref(t["x"], t["dt"], t["A"], t["B"],
                                          t["C"], t["D"], h0=h0)
    assert h_ins.shape == (b, -(-s // 128), din, ds)
    assert _rel(y, y_want) <= 1e-5 and _rel(h, h_want) <= 1e-5
    got = ref.ssm_scan_bwd_ref(t["x"], t["dt"], t["A"], t["B"], t["C"],
                               t["D"], h_ins, t["dy"],
                               t["dh"] if with_dh else None)
    for g, w in zip(got[:6] + ((got[6],) if with_h0 else ()), grads_want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssm_scan_function_on_cpu_equals_reference_vjp(case):
    b, s, din, ds, with_h0, with_dh = case
    x = _scan_inputs(b, s, din, ds, seed=1)
    y_want, h_want, grads_want = _scan_vjp(x, with_h0, with_dh)
    names = ("x", "dt", "A", "B", "C", "D") + (("h0",) if with_h0 else ())
    t = [torch.from_numpy(x[n]).requires_grad_(True) for n in names]
    ops.reset_launch_counts()
    y, h = ops.ssm_scan(*t[:6], h0=t[6] if with_h0 else None)
    outs, cts = [y], [torch.from_numpy(x["dy"])]
    if with_dh:
        outs.append(h)
        cts.append(torch.from_numpy(x["dh"]))
    got = torch.autograd.grad(outs, t, cts)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert _rel(y.detach(), y_want) <= 1e-5
    for g, w in zip(got, grads_want):
        assert _rel(g, w) <= 1e-5


def test_inference_keeps_the_forward_only_path():
    # no grad mode (serving runs under inference_mode): the plain forward,
    # no Function, no saved tensors
    q, k, v, _ = _attn_inputs(ATTN_CASES[0])
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with torch.inference_mode():
        o = ops.flash_attention(*t)
    assert o.grad_fn is None
    x = _scan_inputs(1, 8, 4, 4)
    with torch.no_grad():
        y, _ = ops.ssm_scan(*(torch.from_numpy(x[n]).requires_grad_(True)
                              for n in ("x", "dt", "A", "B", "C", "D")))
    assert y.grad_fn is None


# --- (f) ten train steps of granite-8b reduced -----------------------------

def test_ten_train_steps_granite_track_reference(granite):
    cfg, params = granite
    pcfg = port_config("granite-8b").reduced()
    data = SyntheticStream(DataConfig(cfg.vocab_size, 16, 2, seed=0))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(j_make_step(cfg, jopt.AdamWConfig(**kw)))
    pstep = make_train_step(pcfg, popt.AdamWConfig(**kw))
    jp, js = jax.tree.map(jnp.asarray, params), jopt.init(params)
    pp = bridge.params_from_numpy(params, device="cpu")
    ps = popt.init(pp)
    jl, pl = [], []
    for step in range(10):
        batch = data.batch(step)
        jp, js, loss = jstep(jp, js, {"tokens": jnp.asarray(batch["tokens"])})
        jl.append(float(loss))
        pp, ps, loss = pstep(pp, ps, batch)
        pl.append(float(loss))
    assert np.abs(np.array(pl) - np.array(jl)).max() <= 2e-3
    assert pl[-1] < pl[0] - 0.05 and jl[-1] < jl[0] - 0.05
    assert int(ps.step) == 10


# --- (g) the launcher -------------------------------------------------------

def test_launch_train_saves_and_resumes_on_cpu(tmp_path):
    argv = ["--arch", "granite-8b", "--reduced", "--steps", "6", "--batch",
            "2", "--seq", "16", "--log-every", "3", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path)]
    full = ptrain.main(argv, device="cpu")
    assert len(full) == 6 and np.isfinite(full).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000006"]
    for f in (tmp_path / "step_00000006").iterdir():
        f.unlink()
    (tmp_path / "step_00000006").rmdir()
    resumed = ptrain.main(argv, device="cpu")    # from step 3
    assert resumed == full[3:]


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ptrain.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("d,window,match", [
    (80, 0, "head dim 80"), (256, 0, "head dim 256"),
    (64, 4096, "windowed attention")])
def test_backward_kernels_refuse_untaken_cases(d, window, match):
    # h2o-danube-1.8b's window, its d 80 and paligemma's d 256 have training
    # instances now: the wrappers take the case (`match`) and refuse only
    # what no kernel takes, here CPU tensors, naming the kernel; a head dim
    # with no training instance is refused before anything else
    from repro_torch.kernels import flash_attention as fa
    assert d in fa.TRAIN_HEAD_DIMS, match
    q, k = torch.zeros(1, 2, 4, d), torch.zeros(1, 2, 2, d)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 4, 2), q,
                                    window=window)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fa.flash_attention_cuda(q, k, k, window=window, return_lse=True)
    q, k = torch.zeros(1, 2, 4, 32), torch.zeros(1, 2, 2, 32)
    with pytest.raises(ValueError, match="flash_attention_bwd: head dims 32"):
        fa.flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 4, 2), q,
                                    window=window)
    with pytest.raises(ValueError, match="flash_attention: head dims 32"):
        fa.flash_attention_cuda(q, k, k, window=window, return_lse=True)


def _bwd_bf16_operands(q, k, v, o, lse, do, *, causal, window):
    """attention_bwd_ref's arithmetic with P and dS rounded to bf16 before
    the three products that take them (dV = P^T dO, dK = dS^T Q, dQ = dS K),
    as the tensor-core backward (bf16 at d 64 and 128) feeds them to wgmma
    as register fragments; every sum fp32."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.float().reshape(b, sq, hkv, g, d)
    s = ref._masked_scores(qf, kf, causal=causal, window=window, q_offset=0,
                           kv_len=None, kv_start=None, scale=scale)
    lse = lse.float().reshape(b, hkv, g, sq)
    p = torch.where(s <= ref.NEG_INF / 2, torch.zeros_like(s),
                    torch.exp(s - lse[..., None]))
    delta = (dof * o.float().reshape(b, sq, hkv, g, d)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf.reshape(b, sq, hkv, g, d))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, d)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("window", [0, 24])
def test_bf16_operand_rounding_within_one_ulp(g, window):
    # the gate phase 10 (c) holds the tensor-core backward to on the card:
    # each gradient within one bf16 ulp of its largest (2^-7 of the max) of
    # attention_bwd_ref on the same bf16 inputs, with P and dS rounded to
    # bf16 as wgmma operands; causal, s 96 (no multiple of a 64-row tile)
    rng = np.random.default_rng(20 + g + window)
    b, s, hkv, d = 2, 96, 2, 64
    q, do = (torch.from_numpy(rng.standard_normal((b, s, g * hkv, d),
                                                  np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d),
                                                 np.float32)).bfloat16()
            for _ in range(2))
    o, lse = ref.attention_fwd_lse_ref(q, k, v, causal=True, window=window)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                 window=window)
    got = _bwd_bf16_operands(q, k, v, o, lse, do, causal=True,
                             window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - w.float()).abs().max())
        tol = float(w.float().abs().max()) * 2.0 ** -7 + 1e-6
        assert err <= tol, (name, err, tol)
