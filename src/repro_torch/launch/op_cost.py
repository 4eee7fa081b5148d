"""Op-level cost of one call, counted without a clock.

Twin of ``repro/launch/hlo_cost.py``. The reference parses a compiled XLA
module's HLO text and walks it, multiplying ``while`` bodies by their trip
counts. The port has no HLO: eager PyTorch runs one aten op at a time, so
``count_cost(fn, ...)`` runs ``fn`` under a ``TorchDispatchMode`` and
records every op it dispatches — on the card, on the CPU, or on the
``meta`` device, where nothing is computed and only shapes flow (the
counterpart of ``jax.eval_shape`` / ``.lower()``). The HLO model's
conventions hold:

* FLOPs — products from their contraction dims (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, attention: ``torch.utils.flop_counter``'s
  registry, and ``mv`` / ``dot``; einsum, matmul and the other composite
  ops are counted as the ops they decompose into), one flop per
  result element for every other op that computes (elementwise ops,
  reductions, sorts, dtype casts); none for views, allocations, fills,
  random draws, copies, gathers and scatters.
* Bytes — each op's operand plus result bytes. Views (view, reshape as a
  view, slice, select, transpose, expand, as_strided, detach) count
  nothing. Gathers (``index_select``, ``embedding``, ``index``,
  ``gather``) count the result and the indices, not the table. In-place
  slice writes (``index_put_``, ``scatter``, ``copy_`` into a slice) count
  the update read and written and the indices, not the destination. An
  expanded operand counts its distinct elements.
* Loops — a Python loop dispatches its body once per trip, so trip counts
  need no parsing. A loop of identical trips may iterate ``trips(n, x)``:
  on the meta device one trip then runs and counts n times (the train
  step's microbatches: qwen1.5-110b's train_4k runs 256). Backward —
  autograd's backward ops, and the forward recomputed under ``torch.utils.checkpoint``, dispatch through the same
  mode and are counted, as XLA counts the gradient and remat.
* Collectives — ``heads/sharded.py``'s ``_all_gather`` / ``_pmax`` /
  ``_psum`` record one ``all-gather`` / ``all-reduce`` op each
  (``kernels/cost.py::record_collective``), whatever device the shards
  sit on; torch's functional collectives, which DTensor runs where it
  redistributes (``_c10d_functional.all_gather_into_tensor`` /
  ``reduce_scatter_tensor`` / ``all_reduce`` / ``all_to_all_single``),
  one ``all-gather`` / ``reduce-scatter`` / ``all-reduce`` /
  ``all-to-all`` op each (``wait_tensor`` and ``_wrap_tensor_autograd``
  count nothing). Each one's result bytes, per device, are summed as
  ``collective_bytes`` (``roofline.py::parse_collectives``'s
  convention).
* DTensors — an op on DTensors (a step counted on a mesh,
  ``launch/dryrun.py``) is left to the DTensor, whose local ops and
  collectives come back to the counter at the shard's shapes: the count
  is one device's. The ops DTensor runs on fake tensors to derive a
  result's global shape are not counted.
* Kernels — each CUDA kernel's wrapper (``kernels/*.py``) records one op
  under its kernel's name (``kernels/cost.py::record_kernel``; a
  ``pallas_call`` seen as one custom call), its bytes counted as the
  kernel bound of ``PERF.md`` §6 counts them: each distinct tile once, at
  its dtype's width, plus the kernel's inputs and the results it writes;
  its FLOPs those of the slots the card's kernel computes (the fused
  kernel skips a sentinel slot, the gather computes one over tile 0). The
  counter is suspended while the wrapper runs, so the plain version a CPU
  tensor takes (its (B, K·128) tile, say) leaves no record: a CPU count
  equals the card's.

Bytes do not match the HLO count: XLA counts bytes after fusion, and eager
PyTorch does not fuse, so each elementwise op reads and writes its
operands. Compare FLOPs and argument bytes with the reference, not
``bytes_accessed``.

The counter also tracks the storage the call allocates (each new result's
storage, held while a tensor or view of it lives, through weakref
finalizers): ``OpCost.peak_bytes`` is its peak, the dry run's
``temp_bytes``.

``count_cost`` is not for use inside a CUDA graph capture; the serving
engine's graphs are not counted.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.kernels.cost import tensor_bytes

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# aliases the schema does not mark as views
_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh", "alias"}
# allocations: no flops, no bytes (the storage is tracked)
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided", "empty_permuted"}
# fills and draws: the result written once, no flops (XLA's broadcast of a
# constant, iota, rng-bit-generator)
_FILLS = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
          "new_zeros", "new_ones", "new_full", "fill", "fill_", "zero_",
          "arange", "linspace", "scalar_tensor", "eye", "rand", "randn",
          "rand_like", "randn_like", "randint", "uniform_", "normal_",
          "bernoulli_", "exponential_", "random_"}
# data movement: operands and results, no flops (XLA's copy, concatenate,
# pad, reverse)
_MOVES = {"clone", "cat", "stack", "constant_pad_nd", "flip", "roll",
          "repeat", "contiguous"}
# gathers: the result and the indices, not the table
_GATHERS = {"index_select", "embedding", "index", "_unsafe_index", "gather",
            "take"}
# slice writes: the update read and written, and the indices
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "index_add", "index_add_", "index_copy",
             "index_copy_", "slice_scatter", "select_scatter",
             "diagonal_scatter", "masked_scatter", "masked_scatter_",
             "index_fill", "index_fill_"}
_FREE = {"_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
         "is_same_size", "record_stream", "set_", "resize_"}
# torch's functional collectives (DTensor's redistributions) → the
# reference's kinds; waiting and autograd wrapping count nothing
_C10D = {"all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}
_C10D_FREE = {"wait_tensor", "_wrap_tensor_autograd"}


def _c10d_kind(name: str):
    """The reference's kind of a functional collective op, or None for one
    that counts nothing; raises on one the counter does not know."""
    if name in _C10D_FREE:
        return None
    for op, kind in _C10D.items():
        if name.startswith(op):         # its _out, _coalesced, in-place forms
            return kind
    raise ValueError(f"count_cost: no collective kind for {name}")


@dataclass
class OpRecord:
    """One counted op: its name (an aten op's, a kernel's or a
    collective's), the shapes and dtypes of its results, and its cost."""
    name: str
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    flops: float
    bytes: float


@dataclass
class OpCost:
    """What ``count_cost`` counted (the reference's ``HloCost`` fields, per
    op records, and the peak of the storage the call allocated)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, dict] = field(default_factory=lambda: {
        k: {"bytes": 0.0, "count": 0.0} for k in COLLECTIVES})
    ops: List[OpRecord] = field(default_factory=list)
    peak_bytes: int = 0

    def add_op(self, name: str, results: Sequence[torch.Tensor],
               flops: float, nbytes: float) -> None:
        self.ops.append(OpRecord(name, tuple(tuple(t.shape) for t in results),
                                 tuple(t.dtype for t in results),
                                 float(flops), float(nbytes)))
        self.flops += flops
        self.bytes_accessed += nbytes

    def repeat_since(self, start: int, n: int) -> None:
        """Count the records from ``start`` on ``n`` times in all."""
        for r in self.ops[start:]:
            self.flops += (n - 1) * r.flops
            self.bytes_accessed += (n - 1) * r.bytes
            r.flops *= n
            r.bytes *= n
            if r.name in self.collectives:
                res = sum(math.prod(s) * dt.itemsize
                          for s, dt in zip(r.shapes, r.dtypes))
                self.collective_bytes += (n - 1) * res
                self.collectives[r.name]["bytes"] += (n - 1) * res
                self.collectives[r.name]["count"] += n - 1

    def by_name(self) -> Dict[str, dict]:
        """{op name: {"count", "flops", "bytes"}} over the records."""
        out: Dict[str, dict] = {}
        for r in self.ops:
            e = out.setdefault(r.name, {"count": 0, "flops": 0.0,
                                        "bytes": 0.0})
            e["count"] += 1
            e["flops"] += r.flops
            e["bytes"] += r.bytes
        return out


class _Live:
    """Storage allocated under the counter: each new result's bytes, held
    while the tensor or a view of it lives."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._owner: Dict[int, list] = {}

    def new(self, t: torch.Tensor) -> None:
        if id(t) in self._owner:
            return
        rec = [t.untyped_storage().nbytes(), 0]
        self.now += rec[0]
        self.peak = max(self.peak, self.now)
        self._hold(t, rec)

    def alias(self, t: torch.Tensor, base: torch.Tensor) -> None:
        rec = self._owner.get(id(base))
        if rec is not None and id(t) not in self._owner:
            self._hold(t, rec)

    def _hold(self, t, rec) -> None:
        rec[1] += 1
        self._owner[id(t)] = rec
        weakref.finalize(t, self._drop, id(t), rec)

    def _drop(self, key: int, rec: list) -> None:
        if self._owner.get(key) is rec:
            del self._owner[key]
        rec[1] -= 1
        if rec[1] == 0:
            self.now -= rec[0]


class _Counter(TorchDispatchMode):
    """The dispatch mode ``count_cost`` runs under."""

    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.live = _Live()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # the DTensor runs the op: its local ops and collectives come
            # back here, each at its shard's shapes
            return NotImplemented
        if func is torch.ops.aten.equal.default and \
                args[0].device.type == "meta":
            # DTensor's vocab-parallel gather checks that a mask it reuses
            # is the one it made; meta tensors hold no data to compare
            return args[0].shape == args[1].shape
        if func.overloadpacket not in flop_registry:
            # a composite op (matmul, einsum, linear, ...) reaches the mode
            # whole under inference_mode: count the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self.paused and not any(
                isinstance(t, FakeTensor) for t in tree_leaves(out)):
            # (a DTensor derives a result's global shape by running the op
            # on fake tensors: not work any device does)
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if not outs or name in _FREE:
            return
        if func.namespace == "_c10d_functional":
            kind = _c10d_kind(name)
            if kind is not None:
                self.add_collective(kind, ins, outs[0])
            return
        if func.is_view or name in _VIEWS:
            for t in outs if ins else ():
                self.live.alias(t, ins[0])
            return
        in_ids = {id(t) for t in ins}
        for t in outs:
            if id(t) not in in_ids:
                self.live.new(t)
        if name in _ALLOCS:
            return
        res = sum(tensor_bytes(t) for t in outs)
        flops = 0.0
        if name in _FILLS:
            nbytes = res
        elif name in _MOVES:
            nbytes = res + sum(tensor_bytes(t) for t in ins)
        elif name in _GATHERS:
            nbytes = res + sum(tensor_bytes(t) for t in ins[1:])
        elif name == "copy_":
            nbytes = tensor_bytes(ins[0]) + tensor_bytes(ins[1])
        elif name in _SCATTERS:
            rest = ins[1:]
            idx = sum(tensor_bytes(t) for t in rest
                      if not t.is_floating_point())
            upd = sum(tensor_bytes(t) for t in rest if t.is_floating_point())
            if not upd:          # a scalar fill of the indexed elements
                upd = max((t.numel() for t in rest), default=0) * \
                    ins[0].element_size()
            nbytes = idx + 2 * upd
        else:
            nbytes = res + sum(tensor_bytes(t) for t in ins)
            packet = func.overloadpacket
            if packet in flop_registry:
                flops = float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
            elif name in ("mv", "addmv", "dot", "vdot"):
                # a matrix-vector or vector-vector product: 2 flops a MAC
                flops = 2.0 * max(t.numel() for t in ins)
            else:
                flops = float(sum(t.numel() for t in outs))
        self.cost.add_op(name, outs, flops, nbytes)

    def add_kernel(self, name, results, flops, nbytes, fresh) -> None:
        if fresh:
            for t in results:
                self.live.new(t)
        self.cost.add_op(name, results, flops, nbytes)

    def add_collective(self, kind, parts, result) -> None:
        self.live.new(result)
        res = tensor_bytes(result)
        self.cost.add_op(kind, [result], 0.0,
                         res + sum(tensor_bytes(t) for t in parts))
        self.cost.collective_bytes += res
        self.cost.collectives[kind]["bytes"] += res
        self.cost.collectives[kind]["count"] += 1


def count_cost(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` once, counting every op it dispatches.
    → (fn's output, ``OpCost``)."""
    cost = OpCost()
    counter = _Counter(cost)
    outer, kcost.ACTIVE = kcost.ACTIVE, counter
    try:
        with counter:
            out = fn(*args, **kw)
    finally:
        kcost.ACTIVE = outer
    cost.peak_bytes = counter.live.peak
    return out, cost


def trips(n: int, like: torch.Tensor):
    """``range(n)`` for a loop whose trips all dispatch the same ops on
    tensors of the same shapes. Counted on the meta device, where no trip
    computes anything, one trip runs and its records count ``n`` times
    (the reference's HLO model multiplies a ``while`` body by its trip
    count the same way); anywhere else every trip runs."""
    counter = kcost.ACTIVE
    if counter is None or like.device.type != "meta" or n <= 1:
        yield from range(n)
        return
    start = len(counter.cost.ops)
    yield 0
    counter.cost.repeat_since(start, n)


def materializes_f32_buffer(cost: OpCost, *dims: int) -> bool:
    """True iff some op's result is a float32 tensor of ``prod(dims)``
    elements, in any layout: ``(B, K, 128)`` and ``(B, K·128)`` alike. The
    fused L2S path's memory contract ("the (B, K·V_BLK) candidate-logit tile
    must not exist") is that this is False for its count."""
    n = math.prod(dims)
    return any(dt == torch.float32 and math.prod(shape) == n
               for r in cost.ops for shape, dt in zip(r.shapes, r.dtypes))
