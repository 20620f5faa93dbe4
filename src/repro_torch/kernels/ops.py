"""Dispatch entry points for the compression kernels.

``impl`` selects the path:
  * "cuda"  -- the hand-written CUDA kernels (the deployment path)
  * "torch" -- the plain PyTorch versions (:mod:`repro_torch.kernels.ref`)
  * "auto"  -- "cuda" for CUDA tensors, "torch" for CPU tensors

This module only validates the name and takes ``"torch"`` to the plain
version; every other name goes to the kernel wrapper, which runs its plain
version for a CPU tensor and its kernel for a CUDA tensor.  Both paths write
bit-identical packed words, zero and range: the SR noise is the counter hash
on the global element index and the pack layout is shared.  The CUDA kernels
mask their own ragged edges, so unlike the reference's Pallas entry points
nothing here pads rows to a tile multiple.

An override set by :func:`repro_torch.core.backend.use_impl` replaces every
``impl`` named to this module while it is active.
"""
from __future__ import annotations

import contextvars

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_matmul as fk
from repro_torch.kernels import quant_blockwise as qk
from repro_torch.kernels import ref as refmod
from repro_torch.kernels import rp_matmul as rk

VALID_IMPLS = ("auto", "torch", "cuda")

#: The innermost ``core.backend.use_impl`` override (None: none active).
IMPL_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "impl_override", default=None)


def effective_impl(impl: str) -> str:
    """``impl``, or the active ``use_impl`` override in its place."""
    override = IMPL_OVERRIDE.get()
    return impl if override is None else override


def resolve_impl(impl: str, device) -> str:
    """Concrete impl ("torch" | "cuda") for tensors on ``device``."""
    impl = effective_impl(impl)
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl={impl!r} not in {VALID_IMPLS}")
    is_cuda = torch.device(device).type == "cuda"
    if impl == "auto":
        return "cuda" if is_cuda else "torch"
    if impl == "cuda" and not is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; CPU tensors run "
                         "the plain versions (impl='torch' or 'auto')")
    return impl


def _plain(impl: str, device) -> bool:
    """True when the caller asked for the plain version by name."""
    resolve_impl(impl, device)  # an unknown name, or "cuda" off the card, raises
    return effective_impl(impl) == "torch"


def static_levels(levels):
    """Coerce a VM level table to a hashable tuple of python floats (the
    kernels take the table by value: at most 256 float32 entries, 16 for
    the fused pair)."""
    return None if levels is None else tuple(float(lv) for lv in levels)


def quantize_packed(x2d, bits: int, seed, levels=None, *,
                    impl: str = "auto", rows_per_seed: int | None = None,
                    row0: int = 0, block_stride=None):
    """(n_blocks, G) f32 -> (packed int32, zero (n,), rng (n,)).  ``seed``
    is an int, or a tensor of one seed per run of ``rows_per_seed`` rows;
    ``row0`` is the global block index of row 0 and ``block_stride`` (blocks
    a local row, blocks a global row) a column split's (a shard's
    offset)."""
    levels = static_levels(levels)
    if _plain(impl, x2d.device):
        return refmod.quantize_packed(x2d, bits, seed, levels,
                                      rows_per_seed=rows_per_seed, row0=row0,
                                      block_stride=block_stride)
    return qk.quant_pack(x2d, bits, seed, levels, rows_per_seed=rows_per_seed,
                         row0=row0, block_stride=block_stride)


def dequantize_packed(packed, zero, rng, bits: int, group_size: int,
                      levels=None, *, impl: str = "auto"):
    """(packed, zero (n,), rng (n,)) -> (n_blocks, G) f32."""
    levels = static_levels(levels)
    if _plain(impl, packed.device):
        return refmod.dequantize_packed(packed, zero, rng, bits, group_size,
                                        levels)
    return qk.dequant_unpack(packed, zero, rng, bits, group_size, levels)


def rp_project(x2d, seed: int, d_out: int, *, impl: str = "auto"):
    """x (M, D) @ R(seed) (D, d_out)."""
    if _plain(impl, x2d.device):
        return refmod.rp_project(x2d, seed, d_out)
    return rk.rp_project(x2d.contiguous(), seed, d_out)


def irp_project(x2d, seed: int, d_in: int, *, impl: str = "auto"):
    """x (M, r) @ R(seed)^T (r, d_in)."""
    if _plain(impl, x2d.device):
        return refmod.irp_project(x2d, seed, d_in)
    return rk.irp_project(x2d.contiguous(), seed, d_in)


def matmul_quantize_packed(x2d, w, bits: int, seed: int, levels=None, *,
                           group_size: int, impl: str = "auto"):
    """Fused ``y = x @ w`` with ``x`` quantized+packed beside it: (y (M, N),
    packed int32, zero (nb,), rng (nb,)), the stash bit-equal to
    :func:`quantize_packed` on ``x.reshape(-1, group_size)``.  The caller
    guarantees eligibility (``core.backend.fused_unsupported``)."""
    levels = static_levels(levels)
    if _plain(impl, x2d.device):
        return refmod.matmul_quantize_packed(x2d, w, bits, seed, levels,
                                             group_size=group_size)
    return fk.matmul_quant(x2d.contiguous(), w.contiguous(), bits, seed,
                           levels, group_size=group_size)


def dequant_matmul_packed(packed, zero, rng, g2d, bits: int,
                          group_size: int, d: int, levels=None, *,
                          impl: str = "auto"):
    """Fused ``dw = dequant(packed)^T @ g`` (d, N) for an (M, d) stash."""
    levels = static_levels(levels)
    if _plain(impl, g2d.device):
        return refmod.dequant_matmul_packed(packed, zero, rng, g2d, bits,
                                            group_size, d, levels)
    return fk.dequant_matmul(packed, zero, rng, g2d.contiguous(), bits,
                             group_size, d, levels)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: int | None = None, scale: float | None = None,
                    scale_q: bool = False, impl: str = "auto"):
    """Softmax attention of q (BH, Sq, Dh) over k, v (BH, Skv, Dh) (see
    :func:`repro_torch.kernels.flash_attention.flash_attention`)."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, scale=scale,
              scale_q=scale_q)
    if _plain(impl, q.device):
        return refmod.flash_attention(q, k, v, **kw)
    return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              **kw)
