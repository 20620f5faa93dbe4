"""The counter hash behind stochastic rounding and the random projection,
written out plainly for the reference (murmur3's 32-bit finalizer).

Values are uint32 carried in int64 tensors; each 32 x 32-bit product is
split into 16-bit halves so that no partial product leaves int64.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFF_FFFF
_M1 = 0x85EB_CA6B
_M2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B9
_RADEMACHER_SALT = 0x517C_C1B7


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    lo, hi = x & 0xFFFF, x >> 16
    mid = (hi * (m & 0xFFFF) + lo * (m >> 16)) & 0xFFFF
    return (lo * (m & 0xFFFF) + (mid << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _stream(seed: int, counter: torch.Tensor) -> torch.Tensor:
    hs = fmix32(torch.tensor(int(seed) & MASK32, dtype=torch.int64,
                             device=counter.device))
    return fmix32((_mul32(counter & MASK32, _GOLDEN) + hs) & MASK32)


def uniform(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """U[0, 1) float32 from the top 24 bits of the hash of (seed, counter)."""
    return (_stream(seed, counter) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def rademacher(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """+-1 float32 from the low bit of the hash of (seed + salt, counter)."""
    bits = _stream((int(seed) + _RADEMACHER_SALT) & MASK32, counter) & 1
    return 1.0 - 2.0 * bits.to(torch.float32)
