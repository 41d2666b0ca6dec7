"""Kernel entry points used by the model code (twins of
repro.kernels.ops.flash_attention / decode_attention /
paged_decode_attention / paged_context_attention /
paged_verify_attention, each paged entry with its quantized-pool variant,
and ssm_scan, the Mamba layers' selective scan).

Dispatch is by the tensor's device: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain PyTorch version in ``ref``. The scoped
``backend("plain")`` switch runs the plain versions on the card on purpose,
for tests and chip_smoke.py only; the library never sets it. Each kernel
wrapper counts its launches (``launch_counts``). ``k_scale`` / ``v_scale``
on a paged entry mark a quantized pool (int8 / fp8 payload, float32
per-token-per-head scales) and select its quantized kernel or plain
version.

Training: where grad mode is on and an input requires grad,
``flash_attention`` and ``ssm_scan`` run as ``torch.autograd.Function``s
(``FlashAttentionFn``, ``SsmScanFn``), the port of the reference's
recompute-in-backward custom VJPs (_fa_full, _ssm_chunks): the forward
kernel also keeps what the backward needs (the rows' log-sum-exp; the
state entering every 128-step chunk), and the backward is a kernel of its
own (``flash_attention_bwd``, ``ssm_scan_bwd``, counted like the others).
The forward decides the device path for both: a CUDA tensor launches the
kernels (they build or raise; no fallback), a CPU tensor or
``backend("plain")`` runs the plain versions. Serving runs under
``torch.inference_mode()`` and never takes this path.

Counting: inside a ``launch.op_analysis.OpCounter`` (``COUNTERS``, the
innermost last) each entry point that reaches a kernel hands the counter
its op and bound arguments, and what runs inside it is not counted
(``_counted``); under ``backend("plain")`` it hands over nothing and the
plain versions' ops are counted. A meta tensor takes the plain versions
for their output shapes, except the scan's, whose per-step loop the
kernel backend skips on the meta device (``shapes_only``; a model's own
recurrence runs one step counted n times there, ``repeated``).

``mlstm_scan`` / ``mlstm_step`` (the xLSTM matrix-memory layers) are plain
torch on every device, as the reference computes them with plain jnp: the
JAX package has no Pallas kernel for them.
"""
from __future__ import annotations

import contextlib
import functools
import inspect

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                  flash_attention_cuda)
from repro_torch.kernels.paged_attention import (
    paged_context_attention_cuda, paged_context_attention_quant_cuda,
    paged_decode_attention_cuda, paged_decode_attention_quant_cuda,
    paged_verify_attention_cuda, paged_verify_attention_quant_cuda)
from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda, ssm_scan_cuda

_BACKEND = "kernel"        # "kernel" | "plain"

# the active launch.op_analysis.OpCounter objects, innermost last
COUNTERS = []

KERNELS = {
    "flash_attention": flash_attention_cuda,
    "paged_decode_attention": paged_decode_attention_cuda,
    "paged_context_attention": paged_context_attention_cuda,
    "decode_attention": decode_attention_cuda,
    "paged_verify_attention": paged_verify_attention_cuda,
    "paged_decode_attention_quant": paged_decode_attention_quant_cuda,
    "paged_context_attention_quant": paged_context_attention_quant_cuda,
    "paged_verify_attention_quant": paged_verify_attention_quant_cuda,
    "ssm_scan": ssm_scan_cuda,
    "flash_attention_bwd": flash_attention_bwd_cuda,
    "ssm_scan_bwd": ssm_scan_bwd_cuda,
}


@contextlib.contextmanager
def backend(name: str):
    """``with ops.backend("plain"): ...`` runs the plain versions on CUDA
    tensors too, restoring the previous backend even on error."""
    global _BACKEND
    if name not in ("kernel", "plain"):
        raise ValueError(f"unknown backend {name!r}")
    prev, _BACKEND = _BACKEND, name
    try:
        yield
    finally:
        _BACKEND = prev


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _kernel_for(x) -> bool:
    """A CUDA tensor under the kernel backend launches the kernel; a CPU
    tensor, or a meta tensor (no values: the plain version runs for its
    output shapes), takes the plain version; any other device raises."""
    if x.device.type in ("cpu", "meta"):
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel path for device {x.device}")
    return _BACKEND == "kernel"


@contextlib.contextmanager
def repeated(n: int):
    """Inside OpCounters, count what runs here n times (0: not at all):
    one step of a recurrence run on the meta device, standing for n steps
    of the same shapes."""
    saved = [(c, c.scale) for c in COUNTERS]
    for c, k in saved:
        c.scale = k * n
    try:
        yield
    finally:
        for c, k in saved:
            c.scale = k


class RepeatedStep(torch.autograd.Function):
    """``RepeatedStep.apply(fn, n, k, *inputs)``: step 0 of an n-step
    recurrence, counted as all n (``repeated``). The first k inputs are
    whole sequences (b, n, ...) that fn reads at step 0 (``t[:, 0]``), the
    rest the carried state and weights; fn returns a tuple of tensors. On
    the meta device, where every step has the same shapes, this counts
    what the loop runs: each step's forward and backward n times, and the
    n - 1 sums autograd makes of the sequences' per-step gradients.
    The backward recomputes fn uncounted."""

    @staticmethod
    def forward(ctx, fn, n, k, *inputs):
        ctx.fn, ctx.n, ctx.k = fn, n, k
        ctx.save_for_backward(*inputs)
        with repeated(n):
            return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad(), repeated(0):
            outs = ctx.fn(*inputs)
        need = [t for t in inputs if t.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        with repeated(ctx.n):
            got = torch.autograd.grad([o for o, _ in pairs], need,
                                      [g for _, g in pairs],
                                      allow_unused=True)
        seq = {id(t) for t in inputs[:ctx.k]}
        with repeated(ctx.n - 1):
            for t, g in zip(need, got):
                if id(t) in seq and g is not None:
                    g.clone().add_(g)       # the per-step gradients' sums
        got = iter(got)
        return (None, None, None, *(next(got) if t.requires_grad else None
                                    for t in inputs))


def shapes_only(x) -> bool:
    """A meta tensor under the kernel backend: the scan's outputs are made
    from its shapes (its plain version's per-step loop computes nothing
    on the meta device, and at a dry run's lengths takes minutes)."""
    return x.device.type == "meta" and _BACKEND == "kernel"


def _counted(op, **extra):
    """Decorate an entry point of kernel op `op`: a call on CUDA tensors
    runs with their card as the current device (a TP shard's, or a later
    stage's, may not be the current one); inside an OpCounter (and not
    under backend("plain")) the call is counted once by its registry cost
    (the op's "_quant" variant where k_scale is given; `extra` adds
    arguments computed from the bound ones) and what runs inside it is
    not."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if args and torch.is_tensor(args[0]) and args[0].is_cuda:
                # the kernels launch on the current device's stream: the
                # first tensor's card (a shard's, a replica's) for the call
                with torch.cuda.device(args[0].device):
                    return _entry(*args, **kwargs)
            return _entry(*args, **kwargs)

        def _entry(*args, **kwargs):
            if not COUNTERS or _BACKEND == "plain":
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = dict(bound.arguments)
            a.update(a.pop("mask", {}))
            a.update({k: f(a) for k, f in extra.items()})
            name = op + ("_quant" if a.get("k_scale") is not None else "")
            return COUNTERS[-1].kernel_op(name, a,
                                          lambda: fn(*args, **kwargs))
        return entry
    return wrap


def _quant(k_scale, v_scale) -> bool:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("a quantized pool needs both k_scale and v_scale")
    return k_scale is not None


def _training(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the FA2 backward: the forward keeps o and the rows'
    log-sum-exp, the backward recomputes P from them (kernels #1 with its
    lse and flash_attention_bwd on CUDA tensors, the plain versions
    attention_fwd_lse_ref / attention_bwd_ref otherwise)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, kv_start, scale):
        ctx.kernel = _kernel_for(q)
        ctx.mask = dict(causal=causal, window=window, kv_len=kv_len,
                        kv_start=kv_start, scale=scale)
        if ctx.kernel:
            o, lse = flash_attention_cuda(q, k, v, return_lse=True,
                                          **ctx.mask)
        else:
            o, lse = ref.attention_fwd_lse_ref(q, k, v, **ctx.mask)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_attention_bwd(q, k, v, o, lse, do, ctx.kernel,
                                          **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


@_counted("flash_attention_bwd")
def _flash_attention_bwd(q, k, v, o, lse, do, kernel, **mask):
    bwd = flash_attention_bwd_cuda if kernel else ref.attention_bwd_ref
    return bwd(q, k, v, o, lse, do, **mask)


class SsmScanFn(torch.autograd.Function):
    """The selective scan with the reference's chunked backward: the
    forward keeps the state entering every 128-step chunk, the backward
    re-runs each chunk from it, last first (kernels #9 with its states and
    ssm_scan_bwd on CUDA tensors, the plain versions ssm_scan_states_ref /
    ssm_scan_bwd_ref otherwise). Differentiates y and h_final in x, dt,
    A, B, C, D and h0."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0):
        ctx.kernel = _kernel_for(x)
        ctx.h0 = h0 is not None
        if ctx.kernel:
            y, h, h_ins = ssm_scan_cuda(x, dt, A, B, C, D, h0=h0,
                                        return_states=True)
        elif shapes_only(x):
            y, h = _scan_shapes(x, A)
            h_ins = x.new_empty((x.shape[0], -(-x.shape[1] // ref.CHUNK),
                                 *h.shape[1:]), dtype=torch.float32)
        else:
            y, h, h_ins = ref.ssm_scan_states_ref(x, dt, A, B, C, D, h0=h0)
        ctx.save_for_backward(x, dt, A, B, C, D, h_ins)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C, D, h_ins = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dD, dh0 = _ssm_scan_bwd(
            x, dt, A, B, C, D, h_ins, dy, dh, ctx.kernel)
        return dx, ddt, dA, dB, dC, dD, dh0 if ctx.h0 else None


def _scan_shapes(x, A):
    """The scan's outputs (y, h_final) as empty tensors of their shapes."""
    return torch.empty_like(x), x.new_empty(
        (x.shape[0], x.shape[2], A.shape[-1]), dtype=torch.float32)


@_counted("ssm_scan_bwd")
def _ssm_scan_bwd(x, dt, A, B, C, D, h_ins, dy, dh, kernel):
    if kernel:
        return ssm_scan_bwd_cuda(x, dt, A, B, C, D, h_ins, dy, dh)
    if shapes_only(x):
        return (*(torch.empty_like(t) for t in (x, dt, A, B, C, D)),
                _scan_shapes(x, A)[1])
    return ref.ssm_scan_bwd_ref(x, dt, A, B, C, D, h_ins, dy, dh)


@_counted("flash_attention", lse=lambda a: _training(a["q"], a["k"],
                                                      a["v"]))
def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None,
                    kv_start=None, scale=None):
    """q (b,sq,hq,d); k,v (b,skv,hkv,d); GQA via hq % hkv == 0. window > 0:
    each query sees the previous `window` keys, itself included. Under
    training (grad mode on, an input requiring grad) it runs as
    FlashAttentionFn; a window that covers every key is then dropped, as
    the reference's flash path drops it."""
    if _training(q, k, v):
        if window >= k.shape[1]:
            window = 0
        return FlashAttentionFn.apply(q, k, v, causal, window, kv_len,
                                      kv_start, scale)
    if _kernel_for(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    kv_len=kv_len, kv_start=kv_start,
                                    scale=scale)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             kv_len=kv_len, kv_start=kv_start, scale=scale)


@_counted("decode_attention")
def decode_attention(q, k, v, *, kv_len=None, kv_start=None, scale=None):
    """q (b,1,hq,d) against a contiguous cache k,v (b,S,hkv,d); keys at
    positions >= kv_len or < kv_start (b,) are masked."""
    if _kernel_for(q):
        return decode_attention_cuda(q, k, v, kv_len=kv_len,
                                     kv_start=kv_start, scale=scale)
    return ref.decode_attention_ref(q, k, v, kv_len=kv_len,
                                    kv_start=kv_start, scale=scale)


@_counted("paged_decode_attention")
def paged_decode_attention(q, k_pages, v_pages, block_tables, *, kv_len=None,
                           scale=None, k_scale=None, v_scale=None):
    """q (b,1,hq,d) against pages (n_blocks, block_size, hkv, d) through
    block_tables (b, max_blocks); kv_len (b,) valid lengths. k_scale,
    v_scale (n_blocks, block_size, hkv) float32 mark an int8 / fp8 pool."""
    if _quant(k_scale, v_scale):
        if _kernel_for(q):
            return paged_decode_attention_quant_cuda(
                q, k_pages, v_pages, k_scale, v_scale, block_tables,
                kv_len=kv_len, scale=scale)
        return ref.paged_decode_attention_quant_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables,
            kv_len=kv_len, scale=scale)
    if _kernel_for(q):
        return paged_decode_attention_cuda(q, k_pages, v_pages, block_tables,
                                           kv_len=kv_len, scale=scale)
    return ref.paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_len=kv_len, scale=scale)


@_counted("paged_context_attention")
def paged_context_attention(q, k_pages, v_pages, block_tables, *, q_start,
                            kv_len, scale=None, k_scale=None, v_scale=None):
    """q (b,C,hq,d), row i token j at absolute position q_start[i] + j,
    attending causally to the pages (which already hold the chunk's K/V at
    [q_start, kv_len)) through block_tables. k_scale / v_scale mark a
    quantized pool, as in paged_decode_attention."""
    if _quant(k_scale, v_scale):
        if _kernel_for(q):
            return paged_context_attention_quant_cuda(
                q, k_pages, v_pages, k_scale, v_scale, block_tables,
                q_start=q_start, kv_len=kv_len, scale=scale)
        return ref.paged_context_attention_quant_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables,
            q_start=q_start, kv_len=kv_len, scale=scale)
    if _kernel_for(q):
        return paged_context_attention_cuda(q, k_pages, v_pages,
                                            block_tables, q_start=q_start,
                                            kv_len=kv_len, scale=scale)
    return ref.paged_context_attention_ref(q, k_pages, v_pages, block_tables,
                                           q_start=q_start, kv_len=kv_len,
                                           scale=scale)


@_counted("paged_verify_attention")
def paged_verify_attention(q, k_pages, v_pages, block_tables, *, kv_start,
                           kv_len, scale=None, k_scale=None, v_scale=None):
    """Speculative verification: q (b,T,hq,d), row i's candidate j at
    absolute position kv_start[i] + j (the slot's committed length),
    attending causally to the committed pages and the candidate prefix
    (whose K/V the pages already hold at [kv_start, kv_len)); the output
    is kept at every position. Rows with kv_len == 0 give exact zeros.
    k_scale / v_scale mark a quantized pool, as in paged_decode_attention."""
    if _quant(k_scale, v_scale):
        if _kernel_for(q):
            return paged_verify_attention_quant_cuda(
                q, k_pages, v_pages, k_scale, v_scale, block_tables,
                kv_start=kv_start, kv_len=kv_len, scale=scale)
        return ref.paged_verify_attention_quant_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_tables,
            kv_start=kv_start, kv_len=kv_len, scale=scale)
    if _kernel_for(q):
        return paged_verify_attention_cuda(q, k_pages, v_pages, block_tables,
                                           kv_start=kv_start, kv_len=kv_len,
                                           scale=scale)
    return ref.paged_verify_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_start=kv_start, kv_len=kv_len,
                                          scale=scale)


@_counted("ssm_scan", states=lambda a: _training(
    *(a[n] for n in ("x", "dt", "A", "B", "C", "D", "h0"))))
def ssm_scan(x, dt, A, B, C, D, *, h0=None):
    """Selective scan (Mamba S6): x, dt (b, s, din); A (din, ds); B, C
    (b, s, ds); D (din,); h0 (b, din, ds) or None. Returns (y in x's dtype,
    h_final float32); see ref.ssm_scan_ref. Under training it runs as
    SsmScanFn."""
    if _training(x, dt, A, B, C, D, h0):
        return SsmScanFn.apply(x, dt, A, B, C, D, h0)
    if _kernel_for(x):
        return ssm_scan_cuda(x, dt, A, B, C, D, h0=h0)
    if shapes_only(x):
        return _scan_shapes(x, A)
    return ref.ssm_scan_ref(x, dt, A, B, C, D, h0=h0)


def mlstm_scan(q, k, v, i_gate, f_gate, *, C0=None, n0=None, chunk=128):
    """Chunked mLSTM (twin of the reference's, its chunk length and its
    order of fp32 sums); see ref.mlstm_scan_ref. q, k (b, s, h, dk); v
    (b, s, h, dv); gates (b, s, h) in (0, 1) (sigmoid); C0 (b, h, dk, dv),
    n0 (b, h, dk) or None. Returns (y in q's dtype, (C, n) float32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:                         # pad steps: i = 0, f = 1 (identity)
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, 0, 0, pad))
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=1.0)
    nc = (s + pad) // chunk
    scale = 1.0 / (dk ** 0.5)

    def r(t, *last):
        return t.float().reshape(b, nc, chunk, h, *last)

    qs, ks, vs, i_s, f_s = r(q, dk), r(k, dk), r(v, dv), r(i_gate), \
        r(f_gate)
    dev = q.device
    C = (torch.zeros((b, h, dk, dv), device=dev) if C0 is None
         else C0.float())
    n = torch.zeros((b, h, dk), device=dev) if n0 is None else n0.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))

    def chunk_step(qc, kc, vc, ic, fc, C, n):
        cum = torch.cumsum(torch.log(fc.clamp_min(1e-30)), dim=1)  # log F_t
        # intra-chunk: decay[t, s] = exp(cum_t - cum_s) for s <= t (<= 1)
        dec = torch.exp((cum[:, :, None] - cum[:, None, :]).clamp(max=0.0))
        sc = torch.einsum("bthd,bshd->bhts", qc * scale, kc)
        sc = sc * (dec * ic[:, None, :, :]).permute(0, 3, 1, 2)
        sc = torch.where(tri, sc, torch.zeros_like(sc))
        Ft = torch.exp(cum)                                      # (b, c, h)
        q_dec = qc * scale * Ft[..., None]
        num = torch.einsum("bhts,bshd->bthd", sc, vc) + torch.einsum(
            "bthk,bhkv->bthv", q_dec, C)
        den = (sc.sum(-1).permute(0, 2, 1)
               + torch.einsum("bthk,bhk->bth", q_dec, n)).abs()
        y = num / den.clamp_min(1.0)[..., None]
        # carry: C <- F_c C + sum_s (F_c / F_s) i_s k_s v_s^T
        rdec = torch.exp((cum[:, -1:, :] - cum).clamp(max=0.0)) * ic
        kiv = torch.einsum("bshk,bsh,bshv->bhkv", kc, rdec, vc)
        kin = torch.einsum("bshk,bsh->bhk", kc, rdec)
        Fc = Ft[:, -1]
        return y, Fc[..., None, None] * C + kiv, Fc[..., None] * n + kin

    if shapes_only(q) and nc > 1:       # every chunk has the same shapes
        y, C, n = RepeatedStep.apply(
            lambda *a: chunk_step(*(t[:, 0] for t in a[:5]), *a[5:]), nc, 5,
            qs, ks, vs, i_s, f_s, C, n)
        # torch.stack of the nc chunks' y: the same bytes as this copy
        y = y[:, None].expand(b, nc, *y.shape[1:]).contiguous().reshape(
            b, nc * chunk, h, dv)[:, :s]
        return y.to(q.dtype), (C, n)
    ys = []
    for c in range(nc):
        y, C, n = chunk_step(*(t[:, c] for t in (qs, ks, vs, i_s, f_s)),
                             C, n)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, dv)[:, :s]
    return y.to(q.dtype), (C, n)


def mlstm_step(q_t, k_t, v_t, i_t, f_t, C, n):
    """One mLSTM decode step. q_t, k_t (b, h, dk); v_t (b, h, dv); gates
    (b, h); C (b, h, dk, dv), n (b, h, dk) float32. Returns (y in q_t's
    dtype, (C, n))."""
    scale = 1.0 / (q_t.shape[-1] ** 0.5)
    qf = q_t.float() * scale
    kf = k_t.float()
    C = f_t[..., None, None] * C + i_t[..., None, None] * (
        kf[..., :, None] * v_t.float()[..., None, :])
    n = f_t[..., None] * n + i_t[..., None] * kf
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.einsum("bhk,bhk->bh", qf, n).abs()
    y = num / den.clamp_min(1.0)[..., None]
    return y.to(q_t.dtype), (C, n)
