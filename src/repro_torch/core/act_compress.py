"""Activation-compressed training primitives as ``torch.autograd.Function``s
(the reference's ``repro.core.act_compress``).  Three levels, lowest first:

* :func:`compressed_matmul`: ``y = x @ w`` saving ``compress(x)``.
  ``dx = g @ w^T`` stays exact (it needs only ``w``); only ``dw = x_hat^T
  g`` sees the reconstruction, which is where EXACT puts its estimator.
  :func:`compressed_linear` is the same with a bias, ``db = sum(g, 0)``.
* :func:`compressed_elementwise`: a nonlinearity whose backward evaluates
  ``fn'`` at the reconstruction.
* :func:`compressed_block`: any block ``f(x, params)`` run exactly in the
  forward, its input stored compressed, and ``f`` recomputed from the
  reconstruction in the backward (activation compression plus
  recomputation: how the transformer's layers are wrapped).

``offload=`` on :func:`compressed_matmul` and :func:`compressed_block`
says where the compressed stash waits for the backward: ``None`` /
``"device"`` where it was made, ``"host"`` / ``"pinned-paged"`` in pageable
or page-locked host memory (:class:`repro_torch.offload.engine.HostStash`).
The placement moves bytes, never bits: every placement gives the same
gradients.

The whole-network GNN training forward keeps its own stash walk
(:mod:`repro_torch.engine.forward`); the per-op Functions are what the mesh
engine composes (:func:`repro_torch.engine.forward.mesh_gnn_forward`),
with the same operations in the same order, so both give the same bits.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.compressor import (CompressionConfig, compress,
                                         decompress, decompress_matmul)
from repro_torch.core.prng import MASK32


def _check_offload(offload) -> str | None:
    if offload in (None, "device"):
        return None
    from repro_torch.offload.engine import check_policy

    return check_policy(offload)


def _maybe_offload(ct, offload):
    """The residual: the CompressedTensor itself (None / "device") or its
    host-memory copy."""
    if offload is None:
        return ct
    from repro_torch.offload.engine import offload_compressed

    return offload_compressed(ct, offload)


def _maybe_fetch(res, offload):
    if offload is None:
        return res
    from repro_torch.offload.engine import fetch_compressed

    return fetch_compressed(res)


class _CompressedLinear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, seed: int, cfg: CompressionConfig | None,
                offload: str | None):
        # cfg None stashes the raw input (an uncompressed layer)
        if cfg is None:
            ctx.stash, ctx.stash_nbytes = x, x.numel() * x.element_size()
        else:
            ct = compress(x, cfg, seed)
            ctx.stash, ctx.stash_nbytes = _maybe_offload(ct, offload), ct.nbytes
        ctx.offload = offload
        ctx.save_for_backward(w)
        ctx.has_bias = b is not None
        y = x.to(torch.float32) @ w.to(torch.float32)
        return y if b is None else y + b

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        stash, ctx.stash = ctx.stash, None
        g2 = g.reshape(-1, g.shape[-1])
        if isinstance(stash, torch.Tensor):
            dw = stash.reshape(-1, stash.shape[-1]).T @ g2
        else:
            dw = decompress_matmul(_maybe_fetch(stash, ctx.offload), g2,
                                   fused="off")
        db = g2.sum(dim=0) if ctx.has_bias else None
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        return dx, dw.to(w.dtype), db, None, None, None


def compressed_matmul(x: torch.Tensor, w: torch.Tensor, seed: int,
                      cfg: CompressionConfig | None,
                      offload: str | None = None) -> torch.Tensor:
    """``x @ w`` whose backward reads ``compress(x, cfg, seed)`` for ``dw``
    (``cfg=None`` keeps ``x`` as it is), the stash placed by ``offload``."""
    return _CompressedLinear.apply(x, w, None, int(seed), cfg,
                                   _check_offload(offload))


def compressed_linear(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None, seed: int,
                      cfg: CompressionConfig | None) -> torch.Tensor:
    """``x @ w + b`` with :func:`compressed_matmul`'s stash; the bias
    gradient is ``g.sum(0)``, as the engine's manual backward takes it."""
    return _CompressedLinear.apply(x, w, b, int(seed), cfg, None)


def stash_nbytes(y: torch.Tensor) -> int:
    """Bytes the :func:`compressed_linear` behind ``y`` saved of its input
    (the packed codes with their block scalars and seed, or the raw input)."""
    return y.grad_fn.stash_nbytes


# ---------------------------------------------------------- elementwise
class _CompressedElementwise(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, fn, seed: int, cfg: CompressionConfig):
        ctx.fn, ctx.stash = fn, compress(x, cfg, seed)
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        stash, ctx.stash = ctx.stash, None
        x_hat = decompress(stash).requires_grad_()
        with torch.enable_grad():
            y = ctx.fn(x_hat)
        (dx,) = torch.autograd.grad(y, x_hat, g)
        return dx, None, None, None


def compressed_elementwise(fn, x: torch.Tensor, seed: int,
                           cfg: CompressionConfig) -> torch.Tensor:
    """``fn(x)`` whose backward re-evaluates ``fn'`` at the reconstruction
    of ``compress(x, cfg, seed)``."""
    return _CompressedElementwise.apply(x, fn, int(seed) & MASK32, cfg)


# ----------------------------------------------------------------- block
def _leaves(params) -> list[torch.Tensor]:
    """The tensors of a parameter container (a module, or nested dicts,
    lists and tuples of tensors), in a fixed order."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for key in params for t in _leaves(params[key])]
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in _leaves(p)]
    return []


def shard_rows(x: torch.Tensor, group_size: int) -> tuple[torch.Tensor, int]:
    """A DTensor's local shard and the global block index of its first
    element: the shard must be one contiguous range of the flattened
    tensor (sharded along its first dim, as the batch is), starting and
    ending on whole blocks of ``group_size``.  A plain tensor is its own
    shard at block 0."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x, 0
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if any(p.is_partial() for p in x.placements):
        raise ValueError(f"a stash of a partial sum {x.placements}: "
                         "reduce it first")
    shape = tuple(x.shape)
    local_shape, offset = compute_local_shape_and_global_offset(
        shape, x.device_mesh, x.placements)
    cut = [i for i, (a, b) in enumerate(zip(local_shape, shape)) if a != b]
    if cut and (any(shape[i] != 1 for i in range(cut[0]))
                or len(cut) > 1):
        raise ValueError(f"the local shard of a {shape} DTensor under "
                         f"{x.placements} is not one contiguous range")
    start = offset[cut[0]] * math.prod(shape[cut[0] + 1:]) if cut else 0
    local = x.to_local()
    if start % group_size or local.numel() % group_size:
        raise ValueError(f"the local shard (elements {start}.."
                         f"{start + local.numel()}) does not cover whole "
                         f"blocks of {group_size}")
    return local, start // group_size


class _CompressedBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, f, params, seed: int, cfg: CompressionConfig,
                offload: str | None, *leaves):
        ctx.f, ctx.params, ctx.offload = f, params, offload
        local, row0 = shard_rows(x, cfg.group_size)
        ctx.layout = None if local is x else (
            x.device_mesh, x.placements, x.shape, x.stride())
        ctx.stash = _maybe_offload(compress(local, cfg, seed, row0), offload)
        return f(x, params)

    @staticmethod
    def backward(ctx, g):
        stash, ctx.stash = ctx.stash, None
        x_hat = decompress(_maybe_fetch(stash, ctx.offload))
        if ctx.layout is not None:
            from torch.distributed.tensor import DTensor

            mesh, placements, shape, stride = ctx.layout
            x_hat = DTensor.from_local(x_hat, mesh, placements, shape=shape,
                                       stride=stride)
        x_hat = x_hat.requires_grad_()
        leaves = _leaves(ctx.params)
        wanted = [t for t, need in zip(leaves, ctx.needs_input_grad[6:])
                  if need]
        with torch.enable_grad():
            y = ctx.f(x_hat, ctx.params)
        grads = iter(torch.autograd.grad(y, [x_hat, *wanted], g,
                                         allow_unused=True))
        dx = next(grads)
        dleaves = [next(grads) if need else None
                   for need in ctx.needs_input_grad[6:]]
        return (dx, None, None, None, None, None, *dleaves)


def compressed_block(f, cfg: CompressionConfig, offload: str | None = None):
    """Wrap ``f(x, params) -> y``: store ``compress(x)``, recompute ``f``
    from the reconstruction in the backward.  Returns ``g(x, params, seed)
    -> y``; ``params`` is a module or a nested container of tensors, and
    the backward returns the gradients of ``x`` and of every tensor in it
    that requires one.

    The memory of recomputation (``torch.utils.checkpoint``) except that
    the block input itself is stored block-quantized: the paper's technique
    applied to the residual stream.  The recomputation draws no noise and
    reads the parameters as they are when the backward runs, so they must
    not change between a forward and its backward.  ``offload`` ("host" |
    "pinned-paged") parks the stash in host memory in between.

    A DTensor input (a rank's rows of a batch-sharded residual stream) is
    stored as its local shard, quantized with the shard's global block
    offset (:func:`shard_rows`), so each rank keeps the unsharded stash's
    rows bit for bit; the kernels see only local tensors."""
    offload = _check_offload(offload)

    def g(x, params, seed):
        return _CompressedBlock.apply(x, f, params, int(seed) & MASK32, cfg,
                                      offload, *_leaves(params))

    return g
