"""Plain PyTorch versions of every kernel on the port's path.

The same signatures as the kernel wrappers (and the reference's
``repro.kernels.ref``): the CPU tests run these, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card.  Nothing on the main path calls
them for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import pack as packmod
from repro_torch.core import quant as quantmod
from repro_torch.core import random_projection as rpmod


def quantize_packed(x2d: torch.Tensor, bits: int, seed: int, levels=None):
    """(n_blocks, G) f32 -> (packed int32 (n_blocks, G*bits/32), zero, rng)."""
    codes, zero, rng = quantmod.quantize_grouped(x2d, bits, seed, levels)
    return packmod.pack(codes, bits), zero, rng


def dequantize_packed(packed: torch.Tensor, zero: torch.Tensor,
                      rng: torch.Tensor, bits: int, group_size: int,
                      levels=None) -> torch.Tensor:
    """Inverse of :func:`quantize_packed` -> (n_blocks, G) f32."""
    codes = packmod.unpack(packed, bits, group_size)
    return quantmod.dequantize_grouped(codes, zero, rng, bits, levels)


def rp_project(x2d: torch.Tensor, seed: int, d_out: int) -> torch.Tensor:
    """x (M, D) @ R(seed) (D, d_out), R materialized."""
    return rpmod.rp(x2d, seed, d_out)


def irp_project(x2d: torch.Tensor, seed: int, d_in: int) -> torch.Tensor:
    """x (M, r) @ R(seed).T (r, d_in)."""
    return rpmod.irp(x2d, seed, d_in)
