"""Activation pins against the ambient mesh, and kernels run per device.
Twin of ``repro/utils/shard.py``.

The reference pins activations at block boundaries with
``with_sharding_constraint`` (GSPMD's propagation can lose the batch
sharding through remat and scan and replicate them); here a pin
redistributes a DTensor to the reference's placement. Torch has no ambient
mesh, so ``use_mesh(mesh)`` sets one for the block it opens
(``launch/dryrun.py`` counts a step inside it). Outside a mesh, or given a
plain tensor, ``shard_axis`` and ``shard_batch`` return their input object
unchanged, so every path without a mesh is bit-identical to before.

``per_device`` runs a kernel wrapper on each device's shard of its
DTensor arguments (``torch.distributed.tensor.experimental.local_map``):
the arguments redistributed to the placements the kernel takes, the
wrapper called on the local tensors (so a count records the local shard's
cost, and on the card the kernel launches on them), its results wrapped as
DTensors at the placements GSPMD gives the reference's kernels. Without
it, under ``implicit_replication()``, a wrapper's plain result would be
taken for a replicated tensor of the GLOBAL shape, and its cost counted
for the whole batch.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Sequence

import torch

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh inside the
    block."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    """The innermost ``use_mesh``'s mesh, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def data_axis_names(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def model_axis_size() -> int:
    """Size of the 'model' axis of the ambient mesh (1 if none)."""
    m = ambient_mesh()
    if m is None or "model" not in m.mesh_dim_names:
        return 1
    return int(m.size(m.mesh_dim_names.index("model")))


_DTENSOR = []                    # the DTensor class, once imported


def _dtensor_class():
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_class())


def _axis_size(m, names) -> int:
    return math.prod(m.size(m.mesh_dim_names.index(a)) for a in names)


# -- specs on a mesh ----------------------------------------------------------


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` (a ``PartitionSpec``'s meaning: per
    tensor dim None, an axis name or a tuple of them) on ``mesh``: one per
    mesh dim, ``Shard(d)`` where the mesh dim's axis names tensor dim d
    (alone or in a tuple), else ``Replicate()`` (also for an axis of size
    1, where the two are the same and DTensor's view rules refuse some
    shards)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = _sizes(mesh)
    axes = tuple(sizes)
    where = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        if not set(names) <= set(axes):
            raise ValueError(f"spec {spec}: no mesh axis "
                             f"{sorted(set(names) - set(axes))} in {axes}")
        if list(names) != sorted(names, key=axes.index):
            raise ValueError(f"spec {spec}: {names} not in mesh order")
        for name in names:
            if name in where:
                raise ValueError(f"spec {spec}: axis {name!r} twice")
            where[name] = d
    return tuple(Shard(where[n]) if n in where and sizes[n] > 1
                 else Replicate() for n in axes)


def local_shape(shape, spec, mesh) -> tuple:
    """Each device's shard of a tensor of ``shape`` under ``spec`` (the
    rules shard only dims their axes divide)."""
    sizes = _sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        k = math.prod(sizes[a] for a in names)
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {names}")
        out.append(n // k)
    return tuple(out)


class _Pin(torch.autograd.Function):
    """x redistributed to ``placements``, and its gradient too: the
    reference's ``with_sharding_constraint`` pins the cotangent as it pins
    the value (a plain ``redistribute`` would send the gradient back to x's
    own placements, and DTensor's backward products would then pick their
    own, often replicating the weights' gradients)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def _pin(x, spec):
    return _Pin.apply(x, placements(spec, x.device_mesh))


def shard_axis(x, axis: int, name: str = "model", keep_batch: bool = True):
    """Pin one axis of x over a named mesh axis (no-op without a mesh, on a
    plain tensor, or when the axis does not divide). Used by the
    sequence-parallel attention path.

    ``keep_batch``: also pin axis 0 to the data axes — a spec's None dims
    mean REPLICATED, so leaving the batch out would gather it."""
    m = ambient_mesh()
    if m is None or not is_dtensor(x) or name not in m.mesh_dim_names:
        return x
    if x.shape[axis] % _axis_size(m, (name,)) != 0:
        return x
    spec = (keep_batch and axis != 0 and _batch_spec(x, m)) or \
        [None] * x.dim()
    spec[axis] = name
    return _pin(x, spec)


def shard_batch(x, batch_axis: int = 0):
    """Pin x's batch dim over the mesh's data axes (no-op without a mesh,
    on a plain tensor, without data axes, or for a batch that is 1 or does
    not divide)."""
    m = ambient_mesh()
    if m is None or not is_dtensor(x):
        return x
    spec = _batch_spec(x, m, batch_axis)
    return x if spec is None else _pin(x, spec)


def _batch_spec(x, m, batch_axis: int = 0):
    """``shard_batch``'s spec for x on mesh m, or None where it pins
    nothing."""
    daxes = data_axis_names(m)
    if not daxes:
        return None
    n = x.shape[batch_axis]
    if n <= 1 or n % _axis_size(m, daxes) != 0:
        return None
    spec = [None] * x.dim()
    spec[batch_axis] = daxes if len(daxes) > 1 else daxes[0]
    return spec


def like(y, x):
    """Pin y to x's placements (a partial sum reduced), value and
    gradient: a sublayer's output to its residual stream's. No-op on a
    plain tensor or without a mesh."""
    if ambient_mesh() is None or not (is_dtensor(y) and is_dtensor(x)):
        return y
    from torch.distributed.tensor import Replicate
    return _Pin.apply(y, tuple(Replicate() if p.is_partial() else p
                               for p in x.placements))


def split_as(y, y_dim: int, w, w_dim: int):
    """Pin y's batch split over the data axes (as ``shard_batch``) and its
    ``y_dim`` to split over the mesh dims that split w's ``w_dim``, every
    other dim replicated, value and gradient. No-op on a plain tensor or
    without a mesh."""
    m = ambient_mesh()
    if m is None or not is_dtensor(y):
        return y
    from torch.distributed.tensor import Shard
    want = list(placements(_batch_spec(y, m) or (), m))
    if is_dtensor(w):
        for i, p in enumerate(w.placements):
            if p == Shard(w_dim):
                want[i] = Shard(y_dim)
    return _Pin.apply(y, tuple(want))


def by_rows(make: Callable, x):
    """``make(n)``, a tensor of n rows for x's n batch rows (positions,
    the same for every row). On a DTensor x each device makes only the
    rows it holds, and the result is split over the batch as x is: made
    whole, it would be taken for a replicated tensor of the global batch
    on every device."""
    if not is_dtensor(x):
        return make(x.shape[0])
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    loc = make(x.to_local().shape[0])
    shape = (x.shape[0],) + tuple(loc.shape[1:])
    return DTensor.from_local(loc, mesh, batch_placements(x, mesh),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def tiles(x, n: int):
    """x (L, ...) viewed as (L / n, n, ...). On a DTensor each device views
    its own rows, the splits kept (dim 0's on the tiles, the others one dim
    on): DTensor's own view rules for a split dim differ between torch
    releases (one keeps the split, another gathers the head)."""
    if not is_dtensor(x):
        return x.reshape(-1, n, *x.shape[1:])
    from torch.distributed.tensor import Shard
    pl = tuple(x.placements)
    out = tuple(Shard(p.dim + 1) if isinstance(p, Shard) and p.dim > 0
                else p for p in pl)
    return per_device(lambda t: t.reshape(-1, n, *t.shape[1:]), (x,), (pl,),
                      (out,), mesh=x.device_mesh)


def gather_split(x, dim: int, n: int):
    """x with its split of ``dim`` gathered (a plain ``redistribute``)
    unless a dim of ``n`` elements (``dim`` after a reshape; 0: none) still
    divides over it. No-op on a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    m = x.device_mesh
    split = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    if not split or (n and n % math.prod(m.size(i) for i in split) == 0):
        return x
    return x.redistribute(m, tuple(Replicate() if i in split else p
                                   for i, p in enumerate(x.placements)))


def gathered(x):
    """x with every mesh dim but its batch split replicated (gathered), by
    a plain ``redistribute``: its gradient goes back to x's own placements.
    For an op DTensor has no split rule for (the LSTM's gate split), so
    that the products on either side stay split."""
    if not is_dtensor(x):
        return x
    want = batch_placements(x, x.device_mesh)
    return x if tuple(x.placements) == want else \
        x.redistribute(x.device_mesh, want)


# -- kernels per device -------------------------------------------------------


def mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``."""
    return next(x.device_mesh for x in xs if is_dtensor(x))


def batch_placements(x, mesh, dim: int = 0) -> tuple:
    """x's placements with every mesh dim that does not shard ``dim``
    replicated (all replicated for a plain tensor): a kernel's
    batch-sharded operand and result."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x):
        return replicated(mesh)
    return tuple(p if p == Shard(dim) else Replicate() for p in x.placements)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def per_device(fn: Callable, args: Sequence, in_placements: Sequence,
               out_placements, mesh=None):
    """``fn(*args)`` on each device's shard. ``args``: tensors (a plain
    one taken for replicated) and other values; ``in_placements``: for
    each arg its placements (None for a replicated tensor or a non-tensor);
    ``out_placements``: a tuple of one placements tuple for each tensor
    ``fn`` returns, in order (its outputs flattened).

    A tensor's gradient comes back split as the tensor was, and as a
    partial sum over every mesh dim that replicates it while another
    argument splits there: each device then reads all of it for its own
    part of the work (its rows, heads or experts), and its gradient is
    that part's. An ``fn`` whose result on such a dim is not that part's
    (the same on every device) must say so in its out placements."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = mesh or mesh_of(*args)
    rep = replicated(mesh)
    slots, tensors, specs = [], [], []
    for a, pl in zip(args, in_placements):
        if not isinstance(a, torch.Tensor):
            slots.append((False, a))
            continue
        pl = tuple(pl) if pl is not None else rep
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, rep, run_check=False)
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        slots.append((True, None))
        tensors.append(a)
        specs.append(pl)
    split = {i for pl in specs for i, p in enumerate(pl)
             if isinstance(p, Shard)}
    grads = tuple(tuple(Partial() if i in split and not isinstance(p, Shard)
                        else p for i, p in enumerate(pl)) for pl in specs)

    def local(*ts):
        it = iter(ts)
        return fn(*(next(it) if is_t else v for is_t, v in slots))
    return local_map(local, out_placements=out_placements,
                     in_placements=tuple(specs), in_grad_placements=grads,
                     device_mesh=mesh)(*tensors)


def shard_offset_of(mesh, placements, dim: int, size: int) -> int:
    """Global index of this device's first element along ``dim`` (of
    ``size`` elements) of a DTensor at ``placements`` (its shards split in
    mesh order, outer to inner)."""
    from torch.distributed.tensor import Shard
    coord, idx, n = mesh.get_coordinate(), 0, 1
    for i, p in enumerate(placements):
        if p == Shard(dim):
            idx = idx * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    return idx * (size // n)


def any_dtensor(*xs) -> bool:
    """True if any of ``xs`` is a DTensor (one test a wrapper pays on every
    call, on or off a mesh)."""
    cls = _dtensor_class()
    for x in xs:
        if isinstance(x, cls):
            return True
    return False


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, dim=-1)``. On a DTensor split over its last
    (vocab) dim, from each device's max and sum of exponentials, each
    reduced over the split (GSPMD's vocab-parallel softmax): DTensor's
    ``logsumexp`` gathers the whole vocabulary to every device. The
    result is pinned, value and gradient, to x's batch split, so that the
    gradient meets the exponentials split as they are."""
    from torch.distributed.tensor import Partial, Shard
    last = x.dim() - 1
    if not is_dtensor(x) or Shard(last) not in x.placements:
        return torch.logsumexp(x, dim=-1)
    mesh = x.device_mesh
    bp = batch_placements(x, mesh)
    xp = tuple(p if p == Shard(last) else q for p, q in zip(x.placements, bp))

    def over_split(op):
        return tuple(Partial(op) if p == Shard(last) else q
                     for p, q in zip(xp, bp))
    m = _Pin.apply(per_device(lambda t: torch.amax(t, dim=-1), (x.detach(),),
                              (xp,), (over_split("max"),), mesh=mesh), bp)
    s = per_device(lambda t, mm: torch.sum(torch.exp(t - mm[..., None]),
                                           dim=-1),
                   (x, m), (xp, bp), (over_split("sum"),), mesh=mesh)
    return _Pin.apply(m + torch.log(_Pin.apply(s, bp)), bp)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, an embedding lookup. On DTensors each device looks
    up the ids its vocabulary split holds (zeros for the others) from its
    rows of the table, gathered over any other split (FSDP's d), a partial
    sum over the vocab split, pinned, value and gradient, to the ids'
    batch split (GSPMD's vocab-parallel gather). DTensor's own index rule
    differs between torch releases: one gathers the whole table to every
    device, another splits d and replicates the batch."""
    if not any_dtensor(table, ids):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = mesh_of(table, ids)
    ip = batch_placements(ids, mesh)
    split = [i for i, p in enumerate(getattr(table, "placements", ()))
             if p == Shard(0)]
    tp = tuple(Shard(0) if i in split else Replicate()
               for i in range(mesh.ndim))
    out = tuple(Partial() if i in split else p for i, p in enumerate(ip))
    V = table.shape[0]
    off = shard_offset_of(mesh, tp, 0, V)
    n_loc = V // math.prod(mesh.size(i) for i in split)

    def local(t, i):
        j = i - off
        hit = ((j >= 0) & (j < n_loc))[..., None]
        rows = t[torch.where(hit[..., 0], j, 0)]
        return torch.where(hit, rows, torch.zeros_like(rows))
    return _Pin.apply(per_device(local, (table, ids), (tp, ip), (out,),
                                 mesh=mesh), ip)


def gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx[..., None])[..., 0]``: the gold logit of
    each row. On a DTensor split over its last (vocab) dim each device
    gathers the ids its shard holds and zeros elsewhere, a partial sum
    over the splitting mesh dims (GSPMD's masked gather); DTensor's own
    vocab-parallel gather reuses a mask buffer across ops and fails on the
    meta device."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    last = x.dim() - 1
    mesh = x.device_mesh
    bp = batch_placements(x, mesh)
    xp = tuple(p if p == Shard(last) else q for p, q in zip(x.placements, bp))
    out = tuple(Partial() if p == Shard(last) else q for p, q in zip(xp, bp))
    V = x.shape[-1]

    def local(xl, il):
        off = shard_offset_of(mesh, xp, last, V)
        j = il - off
        hit = (j >= 0) & (j < xl.shape[-1])
        g = torch.gather(xl, -1, torch.where(hit, j, 0)[..., None])[..., 0]
        return torch.where(hit, g, torch.zeros_like(g))
    # summed, and its gradient held, over the batch split alone
    return _Pin.apply(per_device(local, (x, idx), (xp, bp), (out,),
                                 mesh=mesh), bp)
