"""Activation-compressed training primitives as ``torch.autograd.Function``s
(the reference's ``repro.core.act_compress``).

* :func:`compressed_matmul`: ``y = x @ w`` saving ``compress(x)``.
  ``dx = g @ w^T`` stays exact (it needs only ``w``); only ``dw = x_hat^T
  g`` sees the reconstruction, which is where EXACT puts its estimator.
* :func:`compressed_linear`: the same with a bias, ``db = sum(g, 0)``.

The whole-network GNN training forward keeps its own stash walk
(:mod:`repro_torch.engine.forward`); these per-op Functions are what the
mesh engine composes (:func:`repro_torch.engine.forward.mesh_gnn_forward`),
with the same operations in the same order, so both give the same bits.
The rest of the reference's module belongs to the LM's training (ROADMAP
A.11) and raises: ``compressed_elementwise``, ``compressed_block`` and a
host placement of the stash (``offload=`` other than None / "device").
"""
from __future__ import annotations

import torch

from repro_torch.core.compressor import (CompressionConfig, compress,
                                         decompress_matmul)


def _check_offload(offload) -> None:
    if offload not in (None, "device"):
        raise NotImplementedError(
            f"compressed_matmul(offload={offload!r}): host placements of a "
            "per-op stash come with the LM's training (ROADMAP A.11)")


class _CompressedLinear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, seed: int, cfg: CompressionConfig | None):
        # cfg None stashes the raw input (an uncompressed layer)
        ctx.stash = x if cfg is None else compress(x, cfg, seed)
        ctx.stash_nbytes = (x.numel() * x.element_size() if cfg is None
                            else ctx.stash.nbytes)
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
            dw = decompress_matmul(stash, g2, fused="off")
        db = g2.sum(dim=0) if ctx.has_bias else None
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        return dx, dw.to(w.dtype), db, None, None


def compressed_matmul(x: torch.Tensor, w: torch.Tensor, seed: int,
                      cfg: CompressionConfig | None,
                      offload: str | None = None) -> torch.Tensor:
    """``x @ w`` whose backward reads ``compress(x, cfg, seed)`` for ``dw``
    (``cfg=None`` keeps ``x`` as it is).  The stash lives on ``x``'s device;
    the host placements raise (A.11)."""
    _check_offload(offload)
    return _CompressedLinear.apply(x, w, None, int(seed), cfg)


def compressed_linear(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None, seed: int,
                      cfg: CompressionConfig | None) -> torch.Tensor:
    """``x @ w + b`` with :func:`compressed_matmul`'s stash; the bias
    gradient is ``g.sum(0)``, as the engine's manual backward takes it."""
    return _CompressedLinear.apply(x, w, b, int(seed), cfg)


def stash_nbytes(y: torch.Tensor) -> int:
    """Bytes the :func:`compressed_linear` behind ``y`` saved of its input
    (the packed codes with their block scalars and seed, or the raw input)."""
    return y.grad_fn.stash_nbytes


def compressed_elementwise(fn, x, seed, cfg):
    """A nonlinearity whose backward re-evaluates at the reconstruction: the
    LM's training, not ported yet."""
    raise NotImplementedError("compressed_elementwise belongs to the LM's "
                              "training (ROADMAP A.11)")


def compressed_block(f, cfg, offload=None):
    """A block stored compressed and recomputed in the backward: the LM's
    training, not ported yet."""
    raise NotImplementedError("compressed_block belongs to the LM's "
                              "training (ROADMAP A.11)")
