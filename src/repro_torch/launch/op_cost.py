"""Op-level cost model: the FLOPs, bytes, collective bytes and live memory
of one rank's program, counted from the aten ops it dispatches.

Counterpart of ``repro/launch/hlo_cost.py``. The reference walks XLA's
optimized HLO text, weighting each while body by its trip count. Torch has
no HLO, so :class:`OpCost` is a ``TorchDispatchMode`` that sees every aten
op below autograd -- the forward, the backward and the optimizer -- and
costs each by the reference's rules:

  * dot-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``;
    ``einsum``, ``matmul`` and ``linear`` dispatch as these): 2 x output
    elements x contracted size, plus 1 flop per output element for the add
    of ``addmm`` / ``baddbmm`` / ``addmv``;
  * elementwise ops (everything not named below): 1 flop per output
    element;
  * reduce-like ops (sums, maxima, norms, softmax, sorts, scans, scatter
    adds): 1 flop per element of their largest input;
  * data movement (copies, casts, concatenations, gathers, index writes,
    pads, fills, factories): bytes only;
  * views (an output that aliases an input of an op that mutates
    nothing -- XLA's bitcast) and ``empty`` allocations: nothing;
  * bytes: operand bytes plus output bytes of every other op (the
    logical sizes, as HloCostAnalysis counts them);
  * collectives: from the mesh's own counts (``ProcessMesh.stats``, which
    a dry mesh keeps as a real one does), under the reference's names:
    :func:`collective_bytes`.

Loops need no trip counts: Python runs every iteration of a layer loop or
an attention tile loop, and each dispatches its ops. Eager torch fuses
nothing, so its bytes are the unfused program's: they have no bar against
XLA's, whose fusions keep intermediates out of memory.

The same mode tracks live memory: every storage an op puts out is live
from its first output until the storage dies (a ``weakref`` finalizer on
the storage, which torch keeps alive while any tensor or saved-for-backward
reference holds it); :meth:`OpCost.hold` enters the step's arguments
first. ``peak`` is the high-water mark of live bytes, arguments included.

A dry run (``dry=True``) must put out meta tensors only: an op that puts
out a tensor on any other device raises (a 0-d host scalar and an empty
host tensor, such as ``torch.utils.checkpoint``'s marker, excepted), so a
hidden host or device allocation cannot slip into a dry-run's counts.
"""
from __future__ import annotations

import time
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the reference's collective kinds (``hlo_cost._COLLECTIVES``)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ``ProcessMesh`` collective -> the reference's kind. A broadcast is a sum
#: (the other ranks send zeros) and an ``all_max`` a max all-reduce.
_MESH_KIND = {"all_reduce": "all-reduce", "all_max": "all-reduce",
              "broadcast": "all-reduce", "all_gather": "all-gather",
              "reduce_scatter": "reduce-scatter",
              "ppermute": "collective-permute"}

_DOT = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
        "vdot", "convolution", "_convolution"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "aminmax", "prod", "logsumexp", "norm", "linalg_vector_norm",
           "var", "std", "var_mean", "std_mean", "all", "any", "nansum",
           "count_nonzero", "cumsum", "cumprod", "logcumsumexp", "cummax",
           "cummin", "topk", "sort", "argsort", "kthvalue", "median",
           "_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data", "scatter_add", "scatter_reduce",
           "index_add", "index_reduce", "embedding_dense_backward",
           "bincount", "nll_loss_forward", "nll_loss_backward"}
_MOVE = {"copy", "_to_copy", "clone", "_copy_from", "cat", "stack",
         "index_select", "gather", "index", "_unsafe_index", "index_put",
         "_index_put_impl", "slice_scatter", "select_scatter",
         "diagonal_scatter", "as_strided_scatter", "embedding",
         "constant_pad_nd", "repeat", "flip", "roll", "fill", "zero",
         "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
         "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange",
         "scatter", "masked_scatter", "tril", "triu", "expand_copy",
         "permute_copy", "transpose_copy", "view_copy", "unsqueeze_copy",
         "split_with_sizes_copy", "unbind_copy", "lift_fresh_copy",
         "randn", "rand", "normal", "uniform", "bernoulli"}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "resize"}
#: elementwise binary forms of reduce names (``max.other``, ``min.other``)
_ELEMENTWISE_OVERLOADS = {"other"}


def collective_bytes(stats: Dict[str, Dict]) -> Dict[str, float]:
    """A ``ProcessMesh.stats`` dict (``'<op>:<axis>'`` -> calls, bytes)
    -> the reference's ``coll`` dict: bytes per kind and their total. The
    bytes are each call's result, as the reference counts each
    collective's output (a reduce-scatter its input, the larger)."""
    out = {k: 0.0 for k in COLLECTIVES}
    for key, st in stats.items():
        out[_MESH_KIND[key.split(":")[0]]] += st["bytes"]
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def _tensors(args):
    """The tensors among an op's arguments (one level of lists)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _meta_key(a):
    """The part of an op argument that fixes its outputs' metadata."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_meta_key(b) for b in a)
    return a


class _Kind:
    """How one op overload is costed, resolved once per overload.
    ``memo``: a functional op whose outputs alias no input, so the shape,
    strides and dtype of its outputs follow from its arguments' alone."""

    __slots__ = ("name", "cls", "mutates", "view", "memo")

    def __init__(self, func):
        name = func.overloadpacket.__name__
        base = name[:-1] if name.endswith("_") and not name.endswith("__") \
            else name
        self.name = name
        self.mutates = bool(func._schema.is_mutable)
        self.view = not self.mutates and any(
            r.alias_info is not None for r in func._schema.returns)
        self.memo = not (self.mutates or self.view) \
            and func.namespace == "aten"
        if func.namespace != "aten":
            self.cls = "other"
        elif base in _DOT:
            self.cls = "dot"
        elif base in _REDUCE and func._overloadname not in \
                _ELEMENTWISE_OVERLOADS:
            self.cls = "reduce"
        elif base in _ALLOC:
            self.cls = "alloc"
        elif base in _MOVE:
            self.cls = "move"
        else:
            self.cls = "elementwise"


def _dot_flops(name, args, out) -> float:
    n = out.numel()
    if name in ("mm", "bmm"):
        return 2.0 * n * args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addbmm"):
        return 2.0 * n * args[1].shape[-1] + n
    if name == "mv":
        return 2.0 * n * args[0].shape[-1]
    if name == "addmv":
        return 2.0 * n * args[1].shape[-1] + n
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    # convolution(input, weight, bias, ...): each output takes weight's
    # in-channel x kernel window
    w = args[1]
    return 2.0 * n * (w.numel() // max(1, w.shape[0]))


class OpCost(TorchDispatchMode):
    """Counts the aten ops dispatched inside ``with OpCost() as cost:``:
    ``flops``, ``bytes`` (operand + output bytes, views excluded), ``ops``
    (ops dispatched), ``by_op`` (name -> [calls, flops, bytes]) and live
    memory (``live``, ``peak``, ``argument_bytes``). ``dry=True``: every
    tensor an op puts out must be on the meta device."""

    def __init__(self, dry: bool = True):
        super().__init__()
        self.dry = dry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.by_op: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.seconds = 0.0
        self._kinds: Dict[object, _Kind] = {}
        self._storages: Dict[int, int] = {}
        self._memo: Dict[tuple, tuple] = {}

    # -- memory -----------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        """Enter ``t``'s storage as live (once); its new bytes."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        return n

    def _free(self, key: int):
        n = self._storages.pop(key, 0)
        self.live -= n

    def hold(self, tree) -> int:
        """Enter every storage of the tensors in ``tree`` (nested dicts,
        lists and tuples: the step's arguments) as live; adds their bytes
        to ``argument_bytes`` and returns them."""
        from repro_torch.core.tree import leaves
        n = sum(self._track(t) for t in leaves(tree)
                if isinstance(t, torch.Tensor))
        self.argument_bytes += n
        return n

    @staticmethod
    def storage_bytes(tree) -> int:
        """The bytes of the distinct storages under ``tree``."""
        from repro_torch.core.tree import leaves
        seen = {}
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[st._cdata] = st.nbytes()
        return sum(seen.values())

    # -- dispatch ---------------------------------------------------------
    def __enter__(self):
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        return super().__exit__(*exc)

    def _run(self, func, kind, args, kwargs):
        """``func(*args, **kwargs)``. A dry run's meta kernels are Python
        (~0.1-1 ms an elementwise op) and a layer loop repeats the same
        calls, so a functional op's output metadata is kept by its
        arguments' and a repeat call gets fresh meta tensors of the same
        shapes, strides and dtypes without the kernel. An op found to
        return an alias of an input is never kept."""
        if not (self.dry and kind.memo):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(tuple(kwargs.items())))
            meta = self._memo.get(key)
        except TypeError:                       # an unhashable argument
            return func(*args, **kwargs)
        if meta is not None:
            outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                    for sh, st, dt in meta[1]]
            return outs[0] if meta[0] is None else meta[0](outs)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else list(out) \
            if type(out) in (tuple, list) else None
        if outs and all(isinstance(t, torch.Tensor) and t.is_meta
                        for t in outs):
            mine = {t.untyped_storage()._cdata for t in _tensors(args)}
            if any(t.untyped_storage()._cdata in mine for t in outs):
                kind.memo = False
            else:
                self._memo[key] = (None if single else type(out), [
                    (t.shape, t.stride(), t.dtype) for t in outs])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _Kind(func)
        out = self._run(func, kind, args, kwargs)
        self.ops += 1
        ins = list(_tensors(args))
        ins.extend(_tensors(kwargs.values()))
        outs = [out] if isinstance(out, torch.Tensor) else \
            list(_tensors(out)) if isinstance(out, (list, tuple)) else []
        new = 0
        for t in outs:
            if self.dry and not t.is_meta and t.dim() > 0 and t.numel():
                raise RuntimeError(
                    f"{func} put out a {t.device} tensor of shape "
                    f"{tuple(t.shape)} during a dry run")
            new += self._track(t)
        if kind.cls in ("other", "alloc") or kind.view:
            return out
        if not new and not kind.mutates and outs:
            return out                          # a view: nothing moves
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        if kind.cls == "dot":
            fl = _dot_flops(kind.name.rstrip("_"), args, outs[0])
        elif kind.cls == "reduce":
            fl = float(max((t.numel() for t in ins), default=0))
        elif kind.cls == "elementwise":
            fl = float(sum(t.numel() for t in outs))
        else:
            fl = 0.0
        self.flops += fl
        self.bytes += in_b + out_b
        rec = self.by_op[kind.name]
        rec[0] += 1
        rec[1] += fl
        rec[2] += in_b + out_b
        return out
