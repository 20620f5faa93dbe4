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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import quant_blockwise as qk
from repro_torch.kernels import ref as refmod
from repro_torch.kernels import rp_matmul as rk

VALID_IMPLS = ("auto", "torch", "cuda")


def resolve_impl(impl: str, device) -> str:
    """Concrete impl ("torch" | "cuda") for tensors on ``device``."""
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
    return impl == "torch"


def static_levels(levels):
    """Coerce a VM level table to a hashable tuple of python floats (the
    kernels take the table by value, at most 16 float32 entries)."""
    return None if levels is None else tuple(float(lv) for lv in levels)


def quantize_packed(x2d, bits: int, seed: int, levels=None, *,
                    impl: str = "auto"):
    """(n_blocks, G) f32 -> (packed int32, zero (n,), rng (n,))."""
    levels = static_levels(levels)
    if _plain(impl, x2d.device):
        return refmod.quantize_packed(x2d, bits, seed, levels)
    return qk.quant_pack(x2d, bits, seed, levels)


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
