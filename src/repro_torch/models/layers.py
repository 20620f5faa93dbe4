"""Shared neural layers (the reference's ``repro.models.layers``): plain
functions on tensors, and the init helpers with explicit generators.

The reference's matmuls promote their operands (a float32 residual stream
times bf16 weights computes in float32); PyTorch refuses mixed operands, so
:func:`mm` spells the promotion out.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel.annotate import shard


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (JAX's ``x @ w``).  A
    plain ``x`` beside a DTensor ``w`` (a sharded decode step's local
    rows) multiplies ``w``'s shards, the product whole on every rank
    (:func:`repro_torch.parallel.local.matmul`)."""
    if hasattr(w, "placements") and not hasattr(x, "placements"):
        from repro_torch.parallel.local import matmul

        return matmul(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    if hasattr(w, "placements") and not hasattr(x, "placements"):
        from repro_torch.parallel.local import whole

        w = whole(w)
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv * w).to(x.dtype)


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64)
                            / d_head))


@functools.lru_cache(maxsize=None)
def _rope_freqs_f32(d_head: int, theta: float,
                    device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, copied there once (a
    copy from pageable host memory would wait for the card every call)."""
    return torch.from_numpy(rope_freqs(d_head, theta).astype(np.float32)
                            ).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (..., S, H, Dh), positions (..., S) integer."""
    freqs = _rope_freqs_f32(x.shape[-1], float(theta), x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, Dh/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(mm(x, w_gate)) * mm(x, w_up)
    if h.ndim == 3:
        h = shard(h, "batch", None, "dff")
    return mm(h, w_down)


def normal(shape, generator, device=None) -> torch.Tensor:
    """N(0, 1) float32 drawn from ``generator`` (on ``device``, default
    the generator's); ``generator`` may be a device instead, where the
    result holds shapes alone (no draw: ``meta``)."""
    if isinstance(generator, torch.device):
        return torch.empty(shape, device=device or generator)
    return torch.randn(shape, generator=generator,
                       device=device or generator.device)


def dense_init(d_in: int, d_out: int, generator: torch.Generator, *,
               dtype=torch.bfloat16, scale: float | None = None,
               device=None) -> torch.Tensor:
    """N(0, 1) * scale (default ``1/sqrt(d_in)``), drawn in float32 from
    ``generator`` (which sets the device unless ``device`` is given)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return (normal((d_in, d_out), generator, device) * scale).to(dtype)


def embed_init(vocab: int, d_model: int, generator: torch.Generator, *,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return (normal((vocab, d_model), generator, device) * 0.02).to(dtype)
