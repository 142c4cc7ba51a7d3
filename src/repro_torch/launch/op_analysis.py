"""Cost of one call from the aten ops it runs (counterpart of
``repro/launch/hlo_analysis.py``).

The port has no HLO: ``OpTrace``, a ``TorchDispatchMode``, records every
aten op that a call dispatches, with its operands' and results' shapes and
dtypes (never their values), as ``HloModule`` records the instructions of a
compiled module.  It works on ``meta`` tensors, so a cell's whole step can
be counted at production size without a device.  From the record:

* ``dot_flops``        — 2·M·N·K per product (``mm``, ``addmm``, ``bmm``,
                         ``baddbmm``, convolutions, attention ops), by the
                         formulas of ``torch.utils.flop_counter``, so that
                         the total equals ``FlopCounterMode``'s over the
                         same call;
* ``traffic_bytes``    — Σ (operand + result bytes) over the ops of
                         ``HBM_OPS`` (``fusion_aware=True``), or over every
                         op that is not a view (``False``, the pessimistic
                         bound);
* ``collective_bytes`` — bytes per collective kind of the ``c10d`` and
                         ``_c10d_functional`` ops the mode sees;
* ``op_census``        — ops by aten name, plus ``kernel``: the launches of
                         the port's hand-written kernels over the call,
                         read from the wrappers' counters (a ``ctypes``
                         launch is no aten op).

No trip weighting.  A Python loop runs every iteration, so the record holds
what ran: a loop of ten products is ten products, and a data-dependent
branch is counted as taken (or not) in this run, not weighted 1/n as the
reference weights an HLO ``conditional``.

On ``meta`` a pointwise op promotes an fp8 operand with another float
dtype without complaint, where the CPU and CUDA kernels raise ("Promotion
for Float8 Types is not supported").  ``OpTrace`` runs such an op once
more on one-element CPU tensors of the same dtypes, so a ``meta`` run
refuses where a device run would (the ``tuned2`` train cells of
mamba2-780m and recurrentgemma-9b, whose JAX counterparts refuse too).
"""
from __future__ import annotations

import weakref
from array import array
from collections import defaultdict

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# metadata queries: no tensor work, not recorded (FlopCounterMode skips the
# same set)
_META_OPS = frozenset({
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default,
})

# The reference's HBM op set (``HloModule._HBM_OPS``) in aten, by overload
# packet name, and how each op's bytes are counted under
# ``fusion_aware=True``:
#
#   HLO op                 aten ops                          bytes
#   dot, convolution       products (FLOP formula ops)       operands+result
#   copy                   copy_                             src + self
#                          _to_copy, clone                   operands+result
#   transpose              (views: transpose, permute, view, ... cost 0)
#   dynamic-update-slice   index_copy(_), index_put(_),      2 x update
#                          slice_scatter, select_scatter
#   dynamic-slice, gather  index_select, gather, index       2 x result
#   scatter                scatter(_), scatter_add(_),       operands+result
#                          scatter_reduce(_), index_add(_)
#   reduce                 sum, mean, amax, amin, max, min,  operands+result
#                          prod, cumsum, cumprod, logsumexp,
#                          argmax, argmin, any, all, var,
#                          std, var_mean, norm,
#                          linalg_vector_norm
#   sort                   sort, topk                        operands+result
_UPDATE_ARG = {"index_copy": 3, "index_copy_": 3, "index_put": 2,
               "index_put_": 2, "slice_scatter": 1, "select_scatter": 1}
_GATHER_OPS = frozenset({"index_select", "gather", "index"})
_COPY_OPS = frozenset({"_to_copy", "clone"})
_SCATTER_OPS = frozenset({"scatter", "scatter_", "scatter_add",
                          "scatter_add_", "scatter_reduce",
                          "scatter_reduce_", "index_add", "index_add_"})
_REDUCE_OPS = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod",
                         "cumsum", "cumprod", "logsumexp", "argmax", "argmin",
                         "any", "all", "var", "std", "var_mean", "norm",
                         "linalg_vector_norm"})
_SORT_OPS = frozenset({"sort", "topk"})
HBM_OPS = (frozenset({"copy_"}) | _COPY_OPS | frozenset(_UPDATE_ARG) |
           _GATHER_OPS | _SCATTER_OPS | _REDUCE_OPS | _SORT_OPS)

# collectives: op name -> (kind, the argument counted).  The reference's
# conventions: all-gather at its result (here the output argument), the
# others at their operand.
_COLLECTIVES = {
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "result"),
    "_c10d_functional.all_gather_into_tensor_coalesced":
        ("all-gather", "result"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
}


def kernel_wrappers() -> dict:
    """The port's kernel wrappers by name; each counts its launches in
    ``.launches``.  ``bfp_matmul`` and ``bfp_matmul_packed`` count a
    product whose passes and GEMM the three stage wrappers count too."""
    from repro_torch.kernels import bfp_common as bc, bfp_matmul as bm, \
        bfp_quant as bq, flash_attention as fa
    fns = (fa.flash_attention, bm.bfp_matmul, bq.bfp_quantize,
           bq.bfp_matmul_packed, bm.quantize_operand, bq.dequantize_operand,
           bc.gemm_tn)
    return {f.__name__: f for f in fns}


# the wrappers whose count is one device kernel each (``kernel`` in the
# census); the two products are the sum of their stages
_LEAF_KERNELS = ("flash_attention", "bfp_quantize", "quantize_operand",
                 "dequantize_operand", "gemm_tn")


def _meta(x):
    """``(shape, dtype)`` of a tensor, a tuple of them for a list, else
    ``None``."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, (list, tuple)):
        inner = tuple(_meta(y) for y in x)
        return inner if any(m is not None for m in inner) else None
    return None


def _bytes(m) -> int:
    """Bytes of a ``_meta`` record (nested lists summed)."""
    if m is None:
        return 0
    if len(m) == 2 and isinstance(m[1], torch.dtype):
        n = 1
        for d in m[0]:
            n *= d
        return n * m[1].itemsize
    return sum(_bytes(x) for x in m)


_FP8 = frozenset({torch.float8_e4m3fn, torch.float8_e5m2,
                  torch.float8_e4m3fnuz, torch.float8_e5m2fnuz})


_OP_INFO: dict = {}


def _op_info(func) -> tuple:
    """``(decomposes, pointwise, aliases, writes)`` of an op, worked out
    once: whether ``func.decompose`` would run (as ``FlopCounterMode``
    tries it for every op without a FLOP formula), whether the op is
    pointwise, whether its result may share an input's storage (a view, an
    in-place or ``out=`` op), and the ``(position, name)`` of each argument
    it writes."""
    info = _OP_INFO.get(func)
    if info is None:
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        decomposes = func._overloadpacket not in flop_registry and \
            func is not torch.ops.prim.device.default and (
                dk in func.py_kernels or
                torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                               dk))
        aliases = func.is_view or any(r.alias_info is not None
                                      for r in func._schema.returns)
        writes = tuple((i, a.name) for i, a in
                       enumerate(func._schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write)
        info = _OP_INFO[func] = (decomposes, torch.Tag.pointwise in func.tags,
                                 aliases, writes)
    return info


def _check_fp8_promotion(func, args, kwargs) -> None:
    """A pointwise op on ``meta`` with an fp8 operand: run it on CPU
    tensors of one element per dim, the same dtypes, and raise if the
    CPU's type promotion refuses (any other CPU failure, such as a kernel
    the CPU lacks for fp8, is not the device's and passes)."""
    ts = list(_tensors((args, list(kwargs.values()))))
    if not any(t.dtype in _FP8 for t in ts) or \
            not any(t.is_meta for t in ts):
        return

    def small(x):
        if isinstance(x, torch.Tensor):
            return torch.zeros((1,) * x.dim(), dtype=x.dtype)
        if isinstance(x, (list, tuple)):
            return type(x)(small(y) for y in x)
        return x

    try:
        func(*small(args), **{k: small(v) for k, v in kwargs.items()})
    except RuntimeError as e:       # only the promotion, not a CPU gap
        if "Promotion for Float8" in str(e):
            raise
    except NotImplementedError:
        pass


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _propagating() -> bool:
    """DTensor's sharding propagation runs each new op once on fake tensors
    of the global shapes, under a ``FakeTensorMode``: shape work, no
    device's."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _name(func) -> str:
    return f"{func.namespace}.{func._overloadpacket.__name__}"


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _watch_redistributions(trace: "OpTrace"):
    """While ``trace`` records, count by op the redistributions that
    DTensor makes of an op's operands on its own (those that
    ``DTensor.redistribute`` asks for are not counted); the collectives
    they issue reach ``trace`` as any other.  An in-place op whose
    destination DTensor would have to move raises: its write would land
    in a copy.  The storage of each operand so moved into a new one is
    handed to ``trace`` (``OpTrace._moved``): a view op on it returns a
    view of that copy, and a later write through the view would land in
    the copy too.  Returns the function that takes the watch off."""
    disp = _dtensor_type()._op_dispatcher
    prev = disp.__dict__.get("redistribute_local_args")
    orig = disp.redistribute_local_args

    def watched(op_info, suggested, *args, **kwargs):
        op = (op_info.schema or suggested).op
        first = op._schema.arguments[0].alias_info if \
            op._schema.arguments else None
        dest = op_info.local_args[0] if first is not None and \
            first.is_write else None
        before = op_info.local_args
        orig(op_info, suggested, *args, **kwargs)
        trace.implicit[_name(op)] += 1
        for old, new in zip(before, op_info.local_args):
            if isinstance(new, torch.Tensor) and new is not old and not (
                    isinstance(old, torch.Tensor) and
                    _storage(old) == _storage(new)):
                trace._moved(new)
        if dest is not None and op_info.local_args[0] is not dest:
            raise RuntimeError(
                f"DTensor redistributes the destination of the in-place "
                f"{op}: its write would land in a copy")

    disp.redistribute_local_args = watched

    def restore():
        if prev is None:
            del disp.redistribute_local_args
        else:
            disp.redistribute_local_args = prev
    return restore


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


class OpTrace(TorchDispatchMode):
    """Records the aten ops run inside ``with OpTrace() as t:``.

    Each distinct ``(op, operands, result, flops)`` is kept once with its
    count, so a long loop of equal ops costs one entry; ``keep_order=True``
    also keeps the sequence (for ``text()``).  ``peak_bytes`` is the most
    bytes that storages allocated inside the block held at once (outputs
    included, tensors made before the block excluded; ``temp_bytes`` leaves
    the outputs out); ``kernels`` the launches each kernel wrapper counted
    over the block.

    On DTensors it counts one device: each op on DTensors is left to
    DTensor, and what DTensor runs comes back through the mode, the local
    op on the rank's shards and the collectives of any redistribution; the
    DTensor-level op and DTensor's shape propagation (``_propagating``)
    are not recorded.  ``implicit`` counts by op the redistributions that
    DTensor made on its own (``_watch_redistributions``).  An op that
    writes into the storage of such a redistributed copy raises: that is
    a write through a view that DTensor took of a gathered copy (a slice
    along a sharded dim, then ``copy_``), which would leave the DTensor
    as it was; reads through such views are recorded as any other."""

    def __init__(self, keep_order: bool = False):
        super().__init__()
        self.counts: dict = defaultdict(int)
        self.order: list | None = [] if keep_order else None
        self.kernels: dict = {}
        self.implicit: dict = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}     # storage -> (bytes, allocation number)
        self._after = array("q")  # live bytes after each allocation
        self._start: dict = {}
        self._depth = 0           # decompositions re-enter the mode
        self._unwatch = None
        self._copies: set = set()  # storages of redistributed operands

    def __enter__(self):
        if self._depth == 0:
            self._start = {k: f.launches
                           for k, f in kernel_wrappers().items()}
            self._unwatch = _watch_redistributions(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0:
            self.kernels = {k: f.launches - self._start[k]
                            for k, f in kernel_wrappers().items()}
            self._unwatch()
        return out

    def _moved(self, t: torch.Tensor) -> None:
        """Remember ``t``'s storage, a copy that DTensor made of an operand
        on its own, until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._copies:
            self._copies.add(key)
            weakref.finalize(st, self._copies.discard, key)

    def _refuse_write_to_copy(self, func, writes, args, kwargs) -> None:
        for i, name in writes:
            t = args[i] if i < len(args) else kwargs.get(name)
            if isinstance(t, torch.Tensor) and _storage(t) in self._copies:
                raise RuntimeError(
                    f"the in-place {func} writes into a gathered copy: its "
                    f"destination is a view of an operand that DTensor "
                    f"redistributed on its own, so the write would not "
                    f"reach the DTensor")

    def _freed(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _allocated(self, out) -> None:
        """Count each new storage among an op's results (one that does
        not alias an input) until it is freed."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (n, len(self._after))
            self.live_bytes += n
            self._after.append(self.live_bytes)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS or _propagating():
            return func(*args, **kwargs)
        if any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented
        decomposes, pointwise, aliases, writes = _op_info(func)
        if writes and self._copies:
            self._refuse_write_to_copy(func, writes, args, kwargs)
        if decomposes:
            with self:                          # as FlopCounterMode counts
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if pointwise:
            _check_fp8_promotion(func, args, kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        operands = tuple(map(_meta, args))
        if kwargs:
            operands += tuple(_meta(v) for _, v in sorted(kwargs.items()))
        key = (func, operands, _meta(out), flops)
        self.counts[key] += 1
        if self.order is not None:
            self.order.append(key)
        if not aliases:
            self._allocated(out)
        return out

    def temp_bytes(self, out) -> int:
        """``peak_bytes`` less the call's outputs ``out`` (any pytree):
        the most bytes that the block's other allocations held at once, as
        the reference's temp leaves out arguments and outputs.  An output's
        storage is live from its allocation to the end of the block, so it
        is taken off the live bytes from its allocation on."""
        held = {}
        for x in _pytree.tree_leaves(out):
            if isinstance(x, _dtensor_type()):
                x = x.to_local()
            if isinstance(x, torch.Tensor):
                key = x.untyped_storage()._cdata
                if key in self._live:
                    held[key] = self._live[key]
        starts = sorted(held.values(), key=lambda r: r[1])
        peak = taken = j = 0
        for i, live in enumerate(self._after):
            while j < len(starts) and starts[j][1] <= i:
                taken += starts[j][0]
                j += 1
            peak = max(peak, live - taken)
        return peak

    # ------------------------------------------------------------------
    def dot_flops(self) -> int:
        """2·M·N·K over every product that ran."""
        return sum(k[3] * n for k, n in self.counts.items())

    def traffic_bytes(self, fusion_aware: bool = True) -> int:
        """HBM-traffic estimate (bytes) of what ran.

        ``fusion_aware=True``: the ops of ``HBM_OPS`` and the products, each
        by its rule in the table above; elementwise ops fuse into their
        consumers on a compiled path and count nothing.  ``False``: every
        op but views and metadata, operands plus result."""
        total = 0
        for (func, ops, res, flops), n in self.counts.items():
            if func.is_view:
                continue
            name = func._overloadpacket.__name__
            if fusion_aware and not flops and name not in HBM_OPS:
                continue
            if not fusion_aware:
                nbytes = sum(map(_bytes, ops)) + _bytes(res)
            elif name == "copy_":
                nbytes = _bytes(ops[1]) + _bytes(ops[0])
            elif name in _UPDATE_ARG:
                nbytes = 2 * _bytes(ops[_UPDATE_ARG[name]])
            elif name in _GATHER_OPS:
                nbytes = 2 * _bytes(res)
            else:
                nbytes = sum(map(_bytes, ops)) + _bytes(res)
            total += nbytes * n
        return total

    def collective_bytes(self) -> dict:
        """Bytes per collective kind, the reference's conventions:
        all-gather at its result (a ring gather delivers the whole array to
        every participant), the others at their operand; ``total`` over
        the kinds and ``counts`` of each."""
        out: dict = defaultdict(int)
        counts: dict = defaultdict(int)
        for (func, ops, res, _), n in self.counts.items():
            name = _name(func)
            if name not in _COLLECTIVES:
                continue
            kind, where = _COLLECTIVES[name]
            nbytes = _bytes(res) if where == "result" else _bytes(ops[where])
            out[kind] += nbytes * n
            counts[kind] += n
        out["total"] = sum(out[k] for k in COLLECTIVE_KINDS if k in out)
        out["counts"] = dict(counts)
        return dict(out)

    def op_census(self) -> dict:
        """Ops by aten name (``aten.mm``, ``c10d.allreduce_``, ...), and
        ``kernel``: the hand-written kernels launched."""
        census: dict = defaultdict(int)
        for (func, _, _, _), n in self.counts.items():
            census[_name(func)] += n
        census["kernel"] = sum(self.kernels.get(k, 0) for k in _LEAF_KERNELS)
        return dict(census)

    def text(self) -> str:
        """The ops one per line in the order they ran (``keep_order=True``):
        ``op(operand dtypes[shapes]) -> result``, and the FLOPs of a
        product."""
        def line(key):
            func, ops, res, flops = key
            return (f"{func}({', '.join(map(_fmt, ops))}) -> {_fmt(res)}"
                    + (f"  flops={flops}" if flops else ""))
        return "".join(line(k) + "\n" for k in self.order)


def _fmt(m) -> str:
    if m is None:
        return "_"
    if len(m) == 2 and isinstance(m[1], torch.dtype):
        return f"{str(m[1]).removeprefix('torch.')}{list(m[0])}"
    return "[" + ", ".join(map(_fmt, m)) + "]"


def trace(fn, *args, keep_order: bool = False, **kwargs):
    """``(fn(*args, **kwargs), OpTrace)`` of one call."""
    with OpTrace(keep_order=keep_order) as t:
        out = fn(*args, **kwargs)
    return out, t


def analyze(fn, *args, **kwargs) -> dict:
    """The reference's ``analyze`` summary of one call of ``fn``."""
    _, t = trace(fn, *args, **kwargs)
    return {
        "dot_flops": t.dot_flops(),
        "traffic_bytes": t.traffic_bytes(),
        "collectives": t.collective_bytes(),
        "census_top": dict(sorted(t.op_census().items(),
                                  key=lambda kv: -kv[1])[:12]),
    }
