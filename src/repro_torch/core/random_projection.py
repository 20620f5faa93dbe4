"""Normalized Rademacher random projection (paper Eq. 4-5, EXACT's RP/IRP).

``R in {+-1/sqrt(r)}^{D x r}`` from the counter hash: element ``(d, p)`` is
``sign(hash(d * r + p))``.  This module materializes R for the plain path;
the CUDA kernel (:mod:`repro_torch.kernels.rp_matmul`) regenerates tiles of
the same matrix on the fly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.prng import rademacher_from_counter


def rp_scale(d_out: int) -> float:
    """``1/sqrt(d_out)`` rounded as the reference computes it: a float32
    square root, then a float32 division."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d_out)))


def rp_matrix(seed: int, d_in: int, d_out: int, device=None) -> torch.Tensor:
    """The (d_in, d_out) float32 normalized Rademacher matrix for ``seed``."""
    counter = torch.arange(d_in * d_out, dtype=torch.int64, device=device)
    signs = rademacher_from_counter(seed, counter).reshape(d_in, d_out)
    return signs.to(torch.float32) * rp_scale(d_out)


def rp(h: torch.Tensor, seed: int, d_out: int) -> torch.Tensor:
    """Project rows of ``h`` from D to d_out (paper Eq. 4)."""
    return h @ rp_matrix(seed, h.shape[-1], d_out, h.device)


def irp(h_proj: torch.Tensor, seed: int, d_in: int) -> torch.Tensor:
    """Recover (an unbiased estimate of) the original rows (paper Eq. 5)."""
    return h_proj @ rp_matrix(seed, d_in, h_proj.shape[-1], h_proj.device).T
