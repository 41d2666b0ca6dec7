"""Operation and byte counts of a PyTorch step: the port's counterpart of
repro.launch.hlo_analysis, which walks a compiled XLA module.

``OpCounter`` is a ``TorchDispatchMode``: every aten op that runs inside
it is counted as the reference counts a top-level HLO instruction.

  * FLOPs: 2 M N K for the matmul family (``mm``, ``bmm``, ``addmm``,
    ``baddbmm`` and the rest of ``MATMUL``, as ``einsum``, ``linear`` and
    ``matmul`` decompose to them), kept apart as ``matmul_flops`` too;
    a convolution 2 x output elements x its kernel's elements over its
    output channels (``hlo_analysis._conv_flops``); an elementwise op one
    a result element, ``ELEMENTWISE_K`` more for the transcendentals (4
    for exp, log, tanh, sigmoid, erf, sin, cos; 2 for rsqrt, sqrt;
    ``hlo_analysis.py:122-134``); a reduction one an input element.
    Copies, casts, gathers, scatters, fills and concatenations move bytes
    and do no arithmetic.
  * Bytes: the tensor operands plus the results; a view counts none, a
    gather (``GATHERS``) only what it reads, an in-place scatter
    (``SCATTERS``) only the values it writes.
  * Live bytes: the storages the step allocates, tracked through weak
    references; their peak is the counterpart of ``memory_analysis``'s
    ``temp_size_in_bytes``. Storages that were there before the step
    (``exclude``: params, optimizer state, batch, cache) do not count.

Kernel ops are counted once, by formula: each entry point of
``kernels.ops`` that reaches a hand-written kernel (``ops.COUNTERS``)
hands the innermost counter its op and bound arguments, and the counter
adds the FLOPs, bytes and exponentials of ``analysis.registry``'s cost of
that call. Nothing that runs inside the entry point is counted (the
kernel's scratch, its casts and copies, or on the meta device its plain
version, run for its output shapes); its outputs' storages are tracked.
A meta pass and a card pass of the same step therefore count the same
work. Under ``ops.backend("plain")`` the entry points tell the counter
nothing and the plain versions' aten ops are counted instead: what the
reference's default ``"xla"`` backend compiles.

Collectives: on a dry run's card of a mesh, the model tells the counter
each reduction its shard would share with the other cards
(``models.parallel_ctx.collective``); ``coll_bytes`` sums their
per-partition result bytes by kind, as the reference's
``roofline.collective_bytes`` sums an HLO module's.

The compute work is kept by the dtype that does it (``work``): the
matmul family and the kernels at their dtype's tensor-core rate ("bf16",
"fp16", "fp8", "int8"), float32 products (TF32 is off) and every
elementwise op and reduction at "fp32", the rate outside the tensor cores
(PyTorch computes bf16 elementwise ops in float32).
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis import registry
from repro_torch.kernels import ops

MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
          "vdot", "addr"}
CONVOLUTION = {"convolution", "_convolution", "cudnn_convolution",
               "convolution_overrideable"}
ELEMENTWISE_K = {"exp": 4, "exp_": 4, "exp2": 4, "expm1": 4, "log": 4,
                 "log_": 4, "log1p": 4, "log2": 4, "log10": 4, "tanh": 4,
                 "tanh_": 4, "sigmoid": 4, "sigmoid_": 4, "erf": 4,
                 "erfc": 4, "sin": 4, "cos": 4, "atan2": 4,
                 "rsqrt": 2, "rsqrt_": 2, "sqrt": 2, "sqrt_": 2,
                 # composites of those, as XLA would lower them
                 "silu": 5, "silu_": 5, "log_sigmoid_forward": 9,
                 "softplus": 9, "gelu": 9}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
              "argmin", "prod", "var", "std", "var_mean", "std_mean",
              "linalg_vector_norm", "norm", "cumsum", "cumsum_", "cumprod",
              "logsumexp", "topk", "sort", "any", "all", "count_nonzero"}
# max, sub, exp, sum, divide (or log and sub) an element
SOFTMAX = {"_softmax": 8, "_log_softmax": 8,
           "_softmax_backward_data": 3, "_log_softmax_backward_data": 6}
MOVES = {"_to_copy", "copy_", "clone", "cat", "stack", "constant_pad_nd",
         "repeat", "flip", "roll", "fill_", "zero_", "fill", "zeros_like",
         "ones_like", "full_like", "zeros", "ones", "full", "arange",
         "new_zeros", "new_ones", "new_full", "scalar_tensor", "lift_fresh",
         "lift_fresh_copy", "expand_copy", "slice_scatter", "select_scatter",
         "diagonal_scatter", "as_strided_scatter", "contiguous",
         "randint", "random_", "normal_", "uniform_"}
# allocate without writing, or re-label without moving (views the schema
# does not mark): no bytes, no flops
ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "_local_scalar_dense", "set_", "resize_",
          "_unsafe_view", "detach", "lift_fresh", "alias"}
GATHERS = {"index", "index_select", "gather", "embedding",
           "_unsafe_index", "take_along_dim"}
SCATTERS = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
            "scatter_add_", "index_add_", "masked_scatter_",
            "scatter_reduce_"}
# the ops whose exponentials ``exps`` counts (one a result element)
EXPS = {"exp", "exp_", "exp2", "expm1", "sigmoid", "sigmoid_", "tanh",
        "tanh_", "silu", "silu_", "softplus", "log_sigmoid_forward", "gelu",
        "_softmax"}

_WORK = {torch.bfloat16: "bf16", torch.float16: "fp16",
         torch.float8_e4m3fn: "fp8", torch.float8_e5m2: "fp8",
         torch.int8: "int8"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None):
    """The tensors of nested tuples, lists and dicts, in order (a plain
    recursion: a nested closure would make a reference cycle that holds
    the tensors until the cyclic collector runs)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _key(x):
    """A hashable stand-in of an op's arguments: a tensor by its shape,
    strides, dtype and device type; lists as tuples."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(map(_key, x))
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return x


def _matmul_flops(name, args) -> int:
    """2 M N K of a matmul-family op from its operand shapes."""
    if name in ("mm", "addmm"):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "addbmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("mv", "addmv"):
        a = args[-2]
        return 2 * a.shape[0] * a.shape[1]
    if name in ("dot", "vdot"):
        return 2 * args[0].numel()
    if name == "addr":
        return 2 * args[1].numel() * args[2].numel()
    raise KeyError(name)


def _conv_flops(args, out) -> int:
    """2 x output elements x (kernel elements / output channels)."""
    w = args[1]
    k = w.numel() // max(w.shape[0], 1)
    return 2 * out.numel() * max(k, 1)


class OpCounter(TorchDispatchMode):
    """Counts the aten ops (and kernel ops, by formula) run inside it:
    ``flops``, ``matmul_flops``, ``bytes``, ``exps``, ``work`` (FLOPs by
    the dtype whose peak does them), ``coll_bytes`` (a mesh card's
    collectives by kind), ``peak_live_bytes``, ``by_op``
    ({op: [calls, flops, bytes]}) and ``kernels`` ({kernel op: calls}).

    An op's counts depend on its arguments' shapes and dtypes only, so
    they are kept by that key; on the meta device a functional op's
    outputs are made from the kept shapes too, without running its meta
    function again (PyTorch's meta functions are Python and take ~0.1 ms
    an op)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.matmul_flops = 0
        self.bytes = 0
        self.exps = 0
        self.work = collections.Counter()
        self.by_op = collections.defaultdict(lambda: [0, 0, 0])
        self.kernels = collections.Counter()
        self.coll_bytes = collections.Counter()
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.scale = 1          # ops.repeated: a step that stands for n
        self._known = WeakIdKeyDictionary()
        self._inside = 0
        self._seen = {}         # op key -> (counts, meta outputs or None)

    # -- storages ----------------------------------------------------------

    def exclude(self, tree) -> None:
        """Storages of `tree`'s tensors (the step's arguments) are not the
        step's allocations."""
        for t in _tensors(tree):
            self._known[t.untyped_storage()] = False

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            if st in self._known:
                continue
            n = st.nbytes()
            self._known[st] = True
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, n)

    def _freed(self, n) -> None:
        self.live_bytes -= n

    # -- counting ----------------------------------------------------------

    def _add(self, name, flops, nbytes, work_key, matmul=0, exps=0):
        k = self.scale
        self.flops += k * flops
        self.matmul_flops += k * matmul
        self.bytes += k * nbytes
        self.exps += k * exps
        if flops:
            self.work[work_key] += k * flops
        rec = self.by_op[name]
        rec[0] += k
        rec[1] += k * flops
        rec[2] += k * nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:
            return func(*args, **kwargs)
        key = (func, _key(args), _key(kwargs))
        seen = self._seen.get(key)
        if seen is not None and seen[1] == "self":
            out = args[0]
        elif seen is not None and seen[1] is not None:
            spec, metas = seen[1]
            out = tree_unflatten([
                torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")
                if isinstance(m, tuple) else m for m in metas], spec)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if seen is None:
            seen = (self._count(func, args, kwargs, outs),
                    self._meta_outputs(func, args, kwargs, out))
            self._seen[key] = seen
        if not self._inside:
            for c in seen[0]:
                self._add(*c)
            self._track(outs)
        return out

    @staticmethod
    def _meta_outputs(func, args, kwargs, out):
        """How to remake a meta op's outputs when every tensor involved is
        on the meta device: "self" for an in-place op that returns its
        first argument, (spec, leaves) for a functional op (no return
        aliases an input), else None."""
        ins = _tensors((args, kwargs))
        dev = kwargs.get("device")
        on_meta = (all(t.device.type == "meta" for t in ins) if ins
                   else dev is not None and torch.device(dev).type == "meta")
        rets, first = func._schema.returns, func._schema.arguments[:1]
        if not on_meta:
            return None
        if (len(rets) == 1 and rets[0].alias_info is not None
                and rets[0].alias_info.is_write and first
                and first[0].alias_info is not None
                and first[0].alias_info.is_write and out is args[0]):
            return "self"
        if any(r.alias_info is not None for r in rets):
            return None
        leaves, spec = tree_flatten(out)
        return spec, [(tuple(x.shape), x.stride(), x.dtype)
                      if isinstance(x, torch.Tensor) else x for x in leaves]

    def _count(self, func, args, kwargs, outs):
        """[(name, flops, bytes, work key, matmul flops, exps)] of one op."""
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        if name in ALLOCS:
            return [(name, 0, 0, "fp32")]
        if name in GATHERS:
            idx = [t for t in ins if not t.is_floating_point()]
            return [(name, 0, 2 * sum(map(_nbytes, outs))
                     + sum(map(_nbytes, idx)), "fp32")]
        if name in SCATTERS:
            rest = ins[1:]
            vals = [t for t in rest if t.is_floating_point()] or rest[-1:]
            idx = [t for t in rest if not t.is_floating_point()]
            return [(name, 0, 2 * sum(map(_nbytes, vals))
                     + sum(map(_nbytes, idx)), "fp32")]
        nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        n = outs[0].numel() if outs else 0
        if name in MATMUL:
            f = _matmul_flops(name, [a for a in args
                                     if isinstance(a, torch.Tensor)])
            out = [(name, f, nbytes, _WORK.get(ins[-1].dtype, "fp32"), f)]
            if name.startswith("add") or name == "baddbmm":
                # the added term: one operation a result element
                out.append((name + "[add]", n, 0, "fp32"))
            return out
        if name in CONVOLUTION:
            return [(name, _conv_flops(args, outs[0]), nbytes,
                     _WORK.get(ins[0].dtype, "fp32"))]
        if name in MOVES:
            return [(name, 0, nbytes, "fp32")]
        if name in REDUCTIONS:
            return [(name, ins[0].numel() if ins else 0, nbytes, "fp32")]
        k = SOFTMAX.get(name) or ELEMENTWISE_K.get(name, 1)
        return [(name, k * n, nbytes, "fp32", 0, n if name in EXPS else 0)]

    # -- kernel ops (called by kernels.ops' entry points) ------------------

    def kernel_op(self, op, arguments, run):
        """Count kernel op `op` by its registry cost, run it uncounted and
        track its outputs' storages."""
        cost = registry.call_cost(op, arguments)
        self._inside += 1
        try:
            out = run()
            # a kernel's wrapper returns fresh contiguous tensors; the plain
            # version that stands in for it off the card may return views
            out = tree_map(lambda t: t.contiguous() if isinstance(
                t, torch.Tensor) and t.device.type != "cuda" else t, out)
        finally:
            self._inside -= 1
        self.kernels[op] += self.scale
        self._add(op, cost["flops"], cost["bytes"], cost["dtype"],
                  exps=cost["exps"])
        self._track(_tensors(out))
        return out

    # -- collectives (a dry run's card on a mesh: models.parallel_ctx) -----

    def collective(self, kind: str, nbytes: int) -> None:
        """A collective of `kind` whose per-partition result is `nbytes`
        bytes (the reference's per-kind sum of result bytes)."""
        self.coll_bytes[kind] += self.scale * nbytes

    def __enter__(self):
        ops.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.COUNTERS.remove(self)
        return super().__exit__(*exc)
