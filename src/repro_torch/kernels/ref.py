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


def quantize_packed(x2d: torch.Tensor, bits: int, seed, levels=None, *,
                    rows_per_seed: int | None = None, row0: int = 0,
                    block_stride=None):
    """(n_blocks, G) f32 -> (packed int32 (n_blocks, G*bits/32), zero, rng).

    ``seed``: a python int, or a tensor of one seed per run of
    ``rows_per_seed`` rows (each run's counter restarts at 0).  ``row0``:
    the global block index of row 0, and ``block_stride`` (blocks a local
    row, blocks a global row) for a column split (one seed only;
    :func:`repro_torch.core.quant.global_blocks`)."""
    codes, zero, rng = quantmod.quantize_grouped(x2d, bits, seed, levels,
                                                 rows_per_seed=rows_per_seed,
                                                 row0=row0,
                                                 block_stride=block_stride)
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


def matmul_quantize_packed(x2d: torch.Tensor, w: torch.Tensor, bits: int,
                           seed: int, levels=None, *, group_size: int):
    """``y = x @ w`` (f32) and the stash of ``x``: the words, zero and range
    of :func:`quantize_packed` on ``x.reshape(-1, G)`` (the reference's jnp
    composition; ``M * D`` must be whole blocks)."""
    x = x2d.to(torch.float32)
    y = x @ w.to(torch.float32)
    packed, zero, rng = quantize_packed(x.reshape(-1, group_size), bits,
                                        seed, levels)
    return y, packed, zero, rng


def dequant_matmul_packed(packed: torch.Tensor, zero: torch.Tensor,
                          rng: torch.Tensor, g2d: torch.Tensor, bits: int,
                          group_size: int, d: int,
                          levels=None) -> torch.Tensor:
    """``dw = x_hat^T @ g`` (d, N) for the stash of an (M, d) input:
    :func:`dequantize_packed`, then ``x_hat.reshape(M, d).T @ g``."""
    x_hat = dequantize_packed(packed, zero, rng, bits, group_size, levels)
    return x_hat.reshape(-1, d).T @ g2d.to(torch.float32)


#: The reference's finite mask value (``repro.models.attention.NEG_INF``).
NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: int | None = None, scale: float | None = None,
                    scale_q: bool = False) -> torch.Tensor:
    """Plain masked softmax over the full score matrix: q (BH, Sq, Dh), k/v
    (BH, Skv, Dh) -> (BH, Sq, Dh) in q's dtype, float32 inside.  The same
    ``causal``, ``q_offset``, ``kv_len``, ``scale`` and ``scale_q`` as the
    kernel (:func:`repro_torch.kernels.flash_attention.flash_attention`)."""
    sq, dh = q.shape[-2], q.shape[-1]
    skv = k.shape[-2]
    sc = torch.full((), 1.0 / dh ** 0.5 if scale is None else scale,
                    dtype=torch.float32, device=q.device)
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    if scale_q:
        s = (qf * sc) @ kf.transpose(-1, -2)
    else:
        s = (qf @ kf.transpose(-1, -2)) * sc
    kv_pos = torch.arange(skv, device=q.device)
    valid = (kv_pos < (skv if kv_len is None else kv_len))[None, :]
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.to(torch.float32)).to(q.dtype)
