"""Sharding rules (the reference's ``repro.parallel.sharding``): TP (heads,
d_ff, experts over ``model``) + FSDP (parameters over ``data``) + DP (the
batch over ``pod`` x ``data``) + a sequence-sharded KV cache for
long-context decode.

Divisibility policy: a dim shards over an axis only if it divides evenly;
otherwise that dim stays replicated (20-head or 56-head attention on a
16-way model axis keeps replicated attention weights, which FSDP still
shards over ``data``; vocabularies of 92553, 256206 or 50280 stay
unsharded on ``model``).

A spec is a tuple with one entry a dim, as ``jax.sharding.PartitionSpec``
is: an axis name, a tuple of two or more (the dim split over their
product, major first; a tuple of one is its name, as ``PartitionSpec``
normalizes it), or None (replicated).  The rules read only axis sizes, from
a ``DeviceMesh`` or a ``{name: size}`` mapping (:func:`axis_size`), so the
production sizes are evaluated without the production world.
:func:`placements` and :func:`to_named` turn specs into DTensor
placements on a real mesh.

The port's parameters are one module a layer, not the reference's stacked
``(L, ...)`` leaves: :func:`param_pspecs` gives each layer's tensors the
reference's spec with the leading layer ``None`` dropped.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn


def _sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, a mapping, or an object
    with a ``shape`` mapping (the reference tests' ``FakeMesh``)."""
    if isinstance(mesh, dict):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name`` (1 where the mesh lacks it)."""
    return _sizes(mesh).get(name, 1)


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in _sizes(mesh) else ("data",)


def dp_size(mesh) -> int:
    """Total data-parallel degree (product of the DP axis sizes)."""
    total = 1
    for a in dp_axes(mesh):
        total *= axis_size(mesh, a)
    return total


def spec(*entries) -> tuple:
    """A spec of ``entries``, a one-name tuple entry as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _map(rule, tree):
    """``rule(leaf)`` over a nested dict / list / tuple of tensors (or
    anything with ``shape`` and ``ndim``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map(rule, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(rule, v) for v in tree)
    return rule(tree)


def graph_batch_pspecs(batch, mesh, axis: int = 0):
    """Specs for a stacked subgraph-batch tree: the device-group axis
    ``axis`` over the DP axes, everything else replicated (plain data
    parallelism over subgraph batches).  Leaves whose ``axis`` dim does
    not divide the DP degree (or that have no such dim) stay replicated."""
    total = dp_size(mesh)

    def rule(leaf):
        entries = [None] * leaf.ndim
        if leaf.ndim > axis and leaf.shape[axis] % total == 0:
            entries[axis] = dp_axes(mesh)
        return spec(*entries)

    return _map(rule, batch)


def _div(n: int, mesh, axis: str) -> bool:
    return n % axis_size(mesh, axis) == 0


def param_spec(name: str, shape: tuple, mesh) -> tuple:
    """The spec of one parameter by its name (the last key of its path)
    and its own (per-layer) shape."""
    dsz = axis_size(mesh, "data")

    def fsdp(dim: int):
        return "data" if dim % dsz == 0 else None

    def model(dim: int):
        return "model" if _div(dim, mesh, "model") else None

    def out(*spec):
        return tuple(spec) + (None,) * (len(shape) - len(spec))

    if name == "embed":
        return out(model(shape[0]), fsdp(shape[1]))
    if name in ("lm_head", "wq", "wk", "wv", "w_z", "w_x", "w_dt"):
        # flattened out-dim sharding (divisibility, not head count)
        return out(fsdp(shape[0]), model(shape[1]))
    if name in ("wo", "out_proj", "down"):
        return out(model(shape[0]), fsdp(shape[1]))
    if name in ("w_gate", "w_up"):
        if len(shape) == 3:                      # MoE experts (E, D, F)
            return out(model(shape[0]), fsdp(shape[1]), None)
        return out(fsdp(shape[0]), model(shape[1]))
    if name == "w_down":
        if len(shape) == 3:                      # (E, F, D)
            return out(model(shape[0]), None, fsdp(shape[2]))
        return out(model(shape[0]), fsdp(shape[1]))
    if name in ("router", "w_B", "w_C"):
        return out(fsdp(shape[0]), None)
    if name == "conv_x":
        return out(None, model(shape[1]))
    return out()  # norms, biases, scalars: replicated


def _named_leaves(params) -> list[tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    out = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + (str(i),), v)
        else:
            out.append((".".join(prefix), node))

    walk((), params)
    return out


def param_pspecs(cfg, params, mesh) -> dict:
    """``{dotted name: spec}`` for every parameter of ``params`` (a
    :class:`~repro_torch.models.Model`, or the nested dict of
    :func:`~repro_torch.models.transformer.init_params`, on ``meta`` for a
    shape-only walk), keyed as ``named_parameters`` names them
    (``layers.3.attn.wq``).  ``cfg`` is the reference's argument; the
    rules read only names and shapes."""
    del cfg
    return {name: param_spec(name.rsplit(".", 1)[-1], tuple(t.shape), mesh)
            for name, t in _named_leaves(params)}


def batch_pspecs(cfg, shape_kind: str, mesh, batch: int) -> dict:
    """Input-batch specs for train / prefill steps."""
    del shape_kind
    bspec = dp_axes(mesh) if batch % dp_size(mesh) == 0 else None
    out = {"tokens": spec(bspec, None)}
    if cfg.family == "encdec":
        out["enc_embeds"] = spec(bspec, None, None)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = spec(bspec, None, None)
    return out


def cache_pspecs(cfg, cache_shape: dict, mesh, batch: int, seq: int) -> dict:
    """Decode-cache specs over :meth:`Model.init_cache`'s dict.

    batch >= dp: the batch over (pod, data), the cache sequence over
    ``model``.  batch == 1 (long context): the cache sequence over (data,
    model); SSM state heads over ``model``."""
    del cfg, seq
    dp = dp_axes(mesh)
    msz, dp_total = axis_size(mesh, "model"), dp_size(mesh)
    big_batch = batch % dp_total == 0
    bspec = dp if big_batch else None
    seq_axes = "model" if big_batch else (*dp, "model")

    def rule(name, leaf):
        if name == "pos":
            return (None,)
        if name in ("k", "v", "shared_k", "shared_v"):
            # (L|ns, B, S, Hkv, Dh)
            s_ok = leaf.shape[2] % (msz * (1 if big_batch else dp_total)) == 0
            return spec(None, bspec, seq_axes if s_ok else None, None, None)
        if name == "enc":
            return spec(bspec, None, None)
        if name == "conv":
            return spec(None, bspec, None, None)
        if name == "ssd":
            # (L, B, H, P, N)
            h_ok = leaf.shape[2] % msz == 0
            return spec(None, bspec, "model" if h_ok else None, None, None)
        return ()

    return {name: rule(name, leaf) for name, leaf in cache_shape.items()}


# ------------------------------------------------------------ to DTensor
def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): mesh
    dim ``name`` is ``Shard(i)`` where dim ``i``'s entry names it (alone or
    in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """``t`` (the same full tensor on every rank: each keeps its own
    shard, nothing is sent) as a DTensor laid out by ``spec``; ``t`` itself
    on a mesh of one rank, where nothing shards."""
    if mesh.size() == 1:
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def to_named(spec_tree, mesh):
    """The reference's ``to_named``: a tree of specs as a tree of DTensor
    placements on ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: to_named(v, mesh) for k, v in spec_tree.items()}
    return placements(spec_tree, mesh)


#: The families whose layers carry the reference's ``shard`` sites: all
#: six (the SSM's heads and the MoE's experts run on their local shards,
#: :mod:`repro_torch.parallel.local`).
SHARDED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def distribute_model(model: nn.Module, mesh) -> dict:
    """Replace every parameter of ``model`` by its DTensor laid out by
    :func:`param_pspecs` (in place; nothing changes on a mesh of one
    rank).  Returns the specs."""
    specs = param_pspecs(model.cfg, model, mesh)
    if mesh.size() == 1:
        return specs
    if model.cfg.family not in SHARDED_FAMILIES:
        raise ValueError(f"unknown family {model.cfg.family!r}")
    for name, spec in specs.items():
        *owner, leaf = name.split(".")
        mod = model.get_submodule(".".join(owner))
        p = getattr(mod, leaf)
        mod.register_parameter(leaf, nn.Parameter(
            distribute(p.detach(), spec, mesh), requires_grad=p.requires_grad))
    return specs


def distribute_cache(cfg, cache: dict, mesh, batch: int, seq: int) -> dict:
    """A decode cache (:meth:`Model.init_cache`'s dict, the same full
    tensors on every rank) laid out by :func:`cache_pspecs` as DTensors
    (each rank keeps its own shard; nothing is sent)."""
    if mesh.size() == 1:
        return cache
    specs = cache_pspecs(cfg, cache, mesh, batch, seq)
    return {k: distribute(v, specs[k], mesh) for k, v in cache.items()}


def zeros_cache(cfg, shapes: dict, mesh, batch: int, seq: int,
                device) -> dict:
    """Zeros of a decode cache given as ``{name: (shape, dtype)}``
    (``models.transformer.cache_shapes``) on ``device``, laid out by
    :func:`cache_pspecs`, each rank allocating its own shard only."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    specs = cache_pspecs(cfg, {k: SimpleNamespace(shape=shape)
                               for k, (shape, _) in shapes.items()},
                         mesh, batch, seq)
    out = {}
    for name, (shape, dtype) in shapes.items():
        pl = placements(specs[name], mesh)
        local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
        out[name] = DTensor.from_local(
            torch.zeros(local, dtype=dtype, device=device), mesh, pl,
            shape=torch.Size(shape), stride=_contiguous_stride(shape))
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute_batch(cfg, batch: dict, mesh) -> dict:
    """The step inputs laid out by :func:`batch_pspecs`."""
    if mesh.size() == 1:
        return batch
    from torch.distributed.tensor import distribute_tensor

    named = to_named(batch_pspecs(cfg, "train", mesh,
                                  batch["tokens"].shape[0]), mesh)
    return {k: distribute_tensor(v, mesh, named[k], src_data_rank=None)
            for k, v in batch.items()}
