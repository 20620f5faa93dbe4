"""Counter-based deterministic RNG used by stochastic rounding.

The same murmur3 finalizer as the reference (``repro.core.prng``), so the
port draws bit-identical rounding noise and Rademacher signs.  CPU torch has
few ``uint32`` ops, so every value is carried in ``int64`` and masked back
to 32 bits after every step; each 32x32-bit multiply is split into 16-bit
halves so no partial product exceeds 2**48 (signed int64 overflow is never
relied on).  The CUDA kernels compute the same hash in native ``uint32``.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFF_FFFF
M1 = 0x85EB_CA6B
M2 = 0xC2B2_AE35
GOLDEN = 0x9E37_79B9
RADEMACHER_SALT = 0x517C_C1B7

#: Knuth's 32-bit multiplicative-hash constant (floor(2**32 / phi), odd).
KNUTH_MULT = 2654435761


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant m."""
    m_lo, m_hi = m & 0xFFFF, m >> 16
    x_lo, x_hi = x & 0xFFFF, x >> 16
    mid = (x_hi * m_lo + x_lo * m_hi) & 0xFFFF   # each product < 2**32
    return (x_lo * m_lo + (mid << 16)) & MASK32


def as_u32(x) -> torch.Tensor:
    """An int64 tensor holding the uint32 value of ``x`` (python int, or a
    tensor whose integer values are taken mod 2**32)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.tensor(int(x) & MASK32, dtype=torch.int64)


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over uint32 values held in int64."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 13)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def _mix(seed_hash: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    return hash_u32((_mul32(as_u32(counter), GOLDEN) + seed_hash) & MASK32)


def uniform_from_counter(seed, counter: torch.Tensor) -> torch.Tensor:
    """U[0,1) float32 from (seed, uint32 counter array): 24 mantissa bits.

    ``seed`` is a python int or a tensor broadcastable against ``counter``
    (one stream per element, as the 64-bit counter fold in
    :mod:`repro_torch.core.quant` uses)."""
    hs = hash_u32(as_u32(seed).to(counter.device))
    mixed = _mix(hs, counter)
    return (mixed >> 8).to(torch.float32) * (1.0 / (1 << 24))


def rademacher_from_counter(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """+-1 int8 signs from (scalar seed, uint32 counter array)."""
    hs = hash_u32(as_u32((int(seed) + RADEMACHER_SALT) & MASK32)
                  .to(counter.device))
    mixed = _mix(hs, counter)
    return (1 - 2 * (mixed & 1)).to(torch.int8)
