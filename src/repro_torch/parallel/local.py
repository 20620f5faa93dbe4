"""Layers that run on their local shards, with explicit collectives.

Where DTensor's own ops would gather a whole operand, or refuse an op (the
SSD scan's 5-dim einsums, the MoE's expert-slot gathers, the decode
step's in-place cache writes), a layer takes its shards out of DTensor,
computes on plain tensors and puts the result back
(:func:`local_input`, :func:`local_param`, :func:`like`), the way
:func:`repro_torch.models.attention._attend_shards` and
:func:`repro_torch.models.transformer._vocab_parallel_nll` do.  A layer
split over the ``model`` axis (its heads, channels or experts) sums its
partial result with one all-reduce (:func:`reduce`) and sums its input's
gradient with another (:func:`enter`): Megatron's pair of operators.

The decode and prefill steps (no gradient) read a sharded model's
parameters the same way from plain local tensors: :func:`whole` gathers a
parameter, :func:`matmul` runs ``x @ w`` from ``w``'s shards (its columns,
gathered after; or its rows, summed), :func:`lookup` reads a vocabulary
split table, :class:`CacheView` gives a rank's rows and sequence slice of
a cache laid out by ``cache_pspecs`` and :func:`write` fills one.  On an
unsharded model each of them is the plain op, so one code path serves both.

Every collective is the blocking ``torch.distributed`` one over a mesh
axis's group: gloo's functional all-gather does not survive CUDA tensors
(torch 2.11), and the blocking ones also run on ``meta`` tensors under a
``"fake"`` process group (the dry run).  An axis of size 1 sends nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import axis_size

MODEL = "model"


def axis_group(mesh, name: str):
    """The process group of mesh axis ``name``, or None where the mesh
    lacks it or it has one rank (nothing to send)."""
    names = mesh.mesh_dim_names or ()
    if name not in names or mesh.size(names.index(name)) == 1:
        return None
    return mesh.get_group(name)


def axis_rank(mesh, name: str) -> int:
    """This rank's index along axis ``name`` (0 where the mesh lacks it)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


def split_over_model(p) -> bool:
    """True for a DTensor sharded over a ``model`` axis of more than one
    rank."""
    if not hasattr(p, "placements"):
        return False
    mesh = p.device_mesh
    names = mesh.mesh_dim_names or ()
    if MODEL not in names:
        return False
    i = names.index(MODEL)
    return mesh.size(i) > 1 and p.placements[i].is_shard()


def model_group(p):
    """The ``model`` axis's group where DTensor ``p`` is split over it,
    else None (nothing to send)."""
    return axis_group(p.device_mesh, MODEL) if split_over_model(p) else None


def model_rank(p) -> int:
    """This rank's index along ``model`` where ``p`` is split over it, else
    0."""
    return axis_rank(p.device_mesh, MODEL) if split_over_model(p) else 0


def model_dim(w):
    """The dim of DTensor ``w`` split over ``model`` alone (None where it is
    whole there, or that dim is also split over another axis)."""
    if not split_over_model(w):
        return None
    mesh, pl = w.device_mesh, w.placements
    d = pl[mesh.mesh_dim_names.index(MODEL)].dim
    shared = any(p.is_shard(d) and mesh.size(i) > 1 and name != MODEL
                 for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, pl)))
    return None if shared else d


class _Reduce(torch.autograd.Function):
    """Sum over ``group``; the backward passes the gradient on as it is
    (``grad="same"``: what reads the sum is the same on every rank) or sums
    it too (``"sum"``: each rank's reader holds a part)."""

    @staticmethod
    def forward(ctx, x, group, grad):
        ctx.group, ctx.grad = group, grad
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _Enter(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over
    ``group`` (each rank's split layer gave a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ContiguousGrad(torch.autograd.Function):
    """The identity; the backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient comes back contiguous: a local shard's gradient
    handed back to DTensor, whose views of it need its layout (a shard of
    one head, transposed by the attention scan, is not)."""
    return _ContiguousGrad.apply(x)


def reduce(x: torch.Tensor, group, grad: str = "same") -> torch.Tensor:
    """``x`` summed over ``group`` (``x`` itself where ``group`` is None);
    see :class:`_Reduce` for ``grad``."""
    if group is None:
        return x
    return _Reduce.apply(x, group, grad)


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group`` in the backward."""
    if group is None:
        return x
    return _Enter.apply(x, group)


@torch.no_grad()
def reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` (no gradient)."""
    if group is None:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


@torch.no_grad()
def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no
    gradient)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    local = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * local.shape[0], *local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local, group=group)
    return out.movedim(0, dim)


def reduce_all(x: torch.Tensor, groups, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over each group of ``groups``
    in turn (no gradient); ``x`` itself for none."""
    for g in groups:
        x = reduce_max(x, g) if op == "max" else reduce(x, g)
    return x


@torch.no_grad()
def whole(t, keep_model: bool = False) -> torch.Tensor:
    """DTensor ``t``'s local tensor gathered along every mesh axis it is
    split over (but ``model`` where ``keep_model``) with the blocking
    all-gather, inner axes first (a dim split over two axes is split
    major-first); a partial sum is reduced first.  A plain tensor is
    itself.  No gradient: for the decode and prefill steps."""
    if not hasattr(t, "placements"):
        return t
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    if any(p.is_partial() for p in t.placements):
        t = t.redistribute(mesh, tuple(
            Replicate() if p.is_partial() else p for p in t.placements))
    out = t.to_local()
    for i in reversed(range(mesh.ndim)):
        name, pl = mesh.mesh_dim_names[i], t.placements[i]
        if pl.is_shard() and not (keep_model and name == MODEL):
            out = gather(out, axis_group(mesh, name), dim=pl.dim)
    return out


def plain_operand(t, x) -> torch.Tensor:
    """Parameter ``t`` as an op on ``x`` reads it: itself beside a DTensor
    ``x`` (DTensor's op), whole (:func:`whole`) beside a plain one."""
    return t if hasattr(x, "placements") else whole(t)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain ``x`` whole on every rank and a DTensor ``w``,
    the product whole on every rank (no gradient): with ``w``'s columns
    split over ``model``, this rank's columns gathered; with its rows
    split, this rank's slice of ``x`` times them, summed; else ``w``
    gathered."""
    from repro_torch.models.layers import mm

    d = model_dim(w)
    if d is None or w.ndim != 2:
        return mm(x, whole(w))
    wl = whole(w, keep_model=True)
    if d == 1:
        return gather(mm(x, wl), model_group(w), dim=-1)
    n, r = wl.shape[0], model_rank(w)
    return reduce(mm(x[..., r * n:(r + 1) * n], wl), model_group(w))


def lookup(table, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for plain token ids: a table split over ``model``
    by its rows (the vocabulary) is looked up vocab-parallel, each rank's
    rows of its slice summed (no gradient)."""
    if model_dim(table) != 0:
        return whole(table)[tokens]
    el = whole(table, keep_model=True)
    idx = tokens.to(torch.int64) - model_rank(table) * el.shape[0]
    inside = (idx >= 0) & (idx < el.shape[0])
    rows = el[idx.clamp(0, el.shape[0] - 1)] * inside[..., None].to(el.dtype)
    return reduce(rows, model_group(table))


class CacheView:
    """What a decode step reads off its cache (``Model.init_cache``'s dict)
    on the model's mesh (``table``, a parameter, says which): this rank's
    rows of the batch (:meth:`rows`) and their positions ``pos``, each
    K/V entry's local tensor (:meth:`local`) and its sequence slice
    (:meth:`seq`), and a result's rows back as a DTensor (:meth:`wrap`).
    With a cache laid out by ``cache_pspecs``, the batch is split over
    the data axes where it divides (else every rank holds it whole) and
    the K/V sequence over ``model`` (and the data axes); for an unsharded
    model every method is the identity."""

    def __init__(self, table, cache: dict):
        pos = cache["pos"]
        self.mesh = getattr(table, "device_mesh", None)
        self.batch = pos.shape[0]
        if self.mesh is None:
            self.pos = pos
            return
        mesh, names = self.mesh, self.mesh.mesh_dim_names
        dp = [n for n in names if n != MODEL]
        dp_total = 1
        for n in dp:
            dp_total *= axis_size(mesh, n)
        self.big = self.batch % dp_total == 0
        idx = 0
        for n in dp:                        # major-first over the data axes
            idx = idx * axis_size(mesh, n) + axis_rank(mesh, n)
        self.b_local = self.batch // dp_total if self.big else self.batch
        self.b0 = idx * self.b_local if self.big else 0
        pos = pos.full_tensor() if hasattr(pos, "full_tensor") else pos
        self.pos = pos[self.b0:self.b0 + self.b_local]

    def rows(self, t):
        """This rank's rows of batch tensor ``t`` (a DTensor's local shard,
        or a slice of the whole batch)."""
        if self.mesh is None:
            return t
        if hasattr(t, "to_local"):
            return t.to_local()
        return t[self.b0:self.b0 + self.b_local]

    @staticmethod
    def local(c):
        """Cache entry ``c``'s local tensor (writes reach the cache)."""
        return c.to_local() if hasattr(c, "to_local") else c

    def seq(self, c) -> tuple:
        """(first position of this rank's slice of K/V entry ``c``'s
        sequence (L, B, S, Hkv, Dh), the groups it is split over)."""
        if not hasattr(c, "placements"):
            return 0, ()
        axes = [i for i, pl in enumerate(c.placements)
                if pl.is_shard(2) and self.mesh.size(i) > 1]
        names = self.mesh.mesh_dim_names
        idx = 0
        for i in axes:
            idx = idx * self.mesh.size(i) + axis_rank(self.mesh, names[i])
        return idx * c.to_local().shape[2], tuple(
            axis_group(self.mesh, names[i]) for i in axes)

    def wrap(self, t):
        """Local rows ``t`` as a DTensor of the whole batch, laid out as the
        cache's batch (over the data axes where it divides)."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard

        pl = tuple(Shard(0) if self.big and n != MODEL
                   and self.mesh.size(i) > 1 else Replicate()
                   for i, n in enumerate(self.mesh.mesh_dim_names))
        shape = (self.batch, *t.shape[1:])
        return DTensor.from_local(t, self.mesh, pl, shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())


@torch.no_grad()
def write(dst, i: int, src) -> None:
    """``src`` (B, n, ...) written into the leading corner of ``dst[i]``
    (B, N >= n, ...) in place: a cache entry's layer ``i`` from a prefill.
    A DTensor ``dst`` (laid out by ``cache_pspecs``, whole along dim 0)
    takes DTensor ``src`` padded to ``dst[i]``'s shape and laid out as
    ``dst[i]`` by DTensor's redistribute (an all-to-all where the heads
    split gives way to the sequence's: its functional collectives, so a
    sharded prefill runs on the CPU and on ``meta``, not over gloo on the
    card)."""
    if not hasattr(dst, "placements"):
        dst[i][tuple(slice(0, n) for n in src.shape)] = src
        return
    from torch.distributed.tensor import Shard

    from repro_torch.models.transformer import _pad_seq

    if any(p.is_shard(0) for p in dst.placements):
        raise ValueError(f"writing into a cache split along its layers "
                         f"{dst.placements}")
    if src.ndim > 1 and src.shape[1] < dst.shape[2]:
        src = _pad_seq(src, dst.shape[2] - src.shape[1])
    want = tuple(Shard(p.dim - 1) if p.is_shard() else p
                 for p in dst.placements)
    dst.to_local()[i].copy_(src.redistribute(dst.device_mesh,
                                             want).to_local())


def batch_groups(x) -> list:
    """The groups of the mesh axes (but ``model``) DTensor ``x``'s batch
    is split over (none for a plain ``x``)."""
    if not hasattr(x, "placements"):
        return []
    mesh = x.device_mesh
    return [axis_group(mesh, name) for name, pl in
            zip(mesh.mesh_dim_names, x.placements)
            if name != MODEL and pl.is_shard(0)
            and axis_group(mesh, name) is not None]


def batch_mean(t: torch.Tensor, x) -> torch.Tensor:
    """``t``, a mean over this rank's rows of DTensor ``x``'s batch, as the
    mean over the whole batch (equal shards: the sum of the ranks' means
    over their count).  Its reader is the same on every rank, so the
    backward passes each rank its share."""
    for group in batch_groups(x):
        t = reduce(t, group) / dist.get_world_size(group)
    return t


def local_input(x, split: bool) -> torch.Tensor:
    """DTensor ``x``'s local shard (a partial sum reduced first); with
    ``split``, the layer that reads it is split over ``model``, so its
    gradient is summed over that axis (:func:`enter`).  A plain ``x`` is
    itself."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import Replicate

    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
    xl = x.to_local()
    return enter(xl, axis_group(x.device_mesh, MODEL)) if split else xl


def local_param(p, x, split: bool) -> torch.Tensor:
    """Parameter ``p``'s local tensor for a layer on ``x``'s local rows:
    gathered along every mesh axis but ``model`` (FSDP's gather), and
    along ``model`` kept as it is where ``split`` (the layer runs a
    shard's heads or experts), else gathered too.  Its gradient is laid
    out to match: along ``model``, ``p``'s own shard, or a partial sum
    (a replicated weight read by a split layer), or replicated (a layer
    every rank runs whole); along an axis ``x``'s batch is split over, a
    partial sum; replicated elsewhere.  A plain tensor is itself; beside a
    plain ``x`` (local rows, no gradient) it is :func:`whole` (but
    ``model`` where ``split``)."""
    if not hasattr(p, "placements"):
        return p
    if not hasattr(x, "placements"):      # a plain x: no gradient
        return whole(p, keep_model=split)
    from torch.distributed.tensor import Partial, Replicate

    mesh = p.device_mesh
    want, grad = [], []
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, p.placements)):
        if mesh.size(i) == 1:
            want.append(pl)
            grad.append(pl)
        elif name == MODEL and split:
            want.append(pl)
            grad.append(pl if pl.is_shard() else Partial())
        else:
            want.append(Replicate())
            grad.append(Partial() if name != MODEL
                        and x.placements[i].is_shard(0) else Replicate())
    if tuple(want) != tuple(p.placements):
        p = p.redistribute(mesh, tuple(want))
    return p.to_local(grad_placements=tuple(grad))


def like(y: torch.Tensor, x) -> torch.Tensor:
    """Local ``y`` (the same local shape as DTensor ``x``'s shard but the
    last dim) as a DTensor laid out as ``x``; ``y`` itself for a plain
    ``x``."""
    if not hasattr(x, "placements"):
        return y
    from torch.distributed.tensor import DTensor, Replicate

    shape = (*x.shape[:-1], y.shape[-1])
    placements = tuple(Replicate() if p.is_partial() else p
                       for p in x.placements)
    return DTensor.from_local(y, x.device_mesh, placements, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def replicated(t: torch.Tensor, x) -> torch.Tensor:
    """``t`` (the same on every rank) as a DTensor replicated on DTensor
    ``x``'s mesh: its gradient comes back a plain tensor.  ``t`` itself
    beside a plain ``x``."""
    if not hasattr(x, "placements"):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def row_parallel(x, w) -> torch.Tensor:
    """``x @ w`` for DTensor ``x`` whole over ``model`` and ``w`` split
    over ``model`` by its rows: each rank multiplies its slice of ``x``'s
    last dim by its rows and one all-reduce sums them, and ``x``'s
    gradient is summed over the ranks.  DTensor would slice ``x`` itself
    and hand back a gradient split on that dim, whose gather (functional)
    gloo does not survive on CUDA tensors.  Where ``w`` is not split so,
    DTensor's own product."""
    from repro_torch.models.layers import mm

    if not split_over_model(w) or w.placements[
            w.device_mesh.mesh_dim_names.index(MODEL)].dim != 0:
        return mm(x, w)
    group = axis_group(x.device_mesh, MODEL)
    wl = local_param(w, x, True)
    n, r = wl.shape[0], axis_rank(x.device_mesh, MODEL)
    xl = local_input(x, True)
    return like(reduce(mm(xl[..., r * n:(r + 1) * n], wl), group), x)
