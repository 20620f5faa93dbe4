"""Dense bit-packing of quantization codes into 32-bit words.

The reference's STRIDED layout (``repro.core.pack``): with ``W = n / v``
words per row (``v = 32 / bits`` codes per word), word ``j`` holds codes
``[j, j+W, j+2W, ...]`` in its bit-fields, low bits first.  torch has no
general ``uint32`` arithmetic, so words are stored as ``int32`` bit-views of
the unsigned values (the CUDA kernels write the same bits).
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32


def vals_per_word(bits: int) -> int:
    if 32 % bits:
        raise ValueError(f"bits={bits} must divide 32")
    return 32 // bits


def packed_len(n: int, bits: int) -> int:
    v = vals_per_word(bits)
    return (n + v - 1) // v


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> their int32 bit-view."""
    return torch.where(words >= (1 << 31), words - (1 << 32),
                       words).to(torch.int32)


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int codes (values < 2**bits) along the last axis into int32."""
    v = vals_per_word(bits)
    *lead, n = codes.shape
    c = codes.to(torch.int64)
    pad = (-n) % v
    if pad:
        c = torch.cat([c, c.new_zeros((*lead, pad))], dim=-1)
    c = c.reshape(*lead, v, -1)        # chunk k = columns [k*W, (k+1)*W)
    shifts = torch.arange(v, device=c.device, dtype=torch.int64) * bits
    return _to_int32((c << shifts[:, None]).sum(dim=-2))


def unpack(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Unpack int32 words back to int32 codes; ``n`` = valid count per row."""
    v = vals_per_word(bits)
    mask = (1 << bits) - 1
    w = words.to(torch.int64) & MASK32
    shifts = torch.arange(v, device=w.device, dtype=torch.int64) * bits
    c = (w[..., None, :] >> shifts[:, None]) & mask
    *lead, _, nw = c.shape
    return c.reshape(*lead, v * nw)[..., :n].to(torch.int32)


def packed_nbytes(shape: tuple[int, ...], bits: int, group_size: int) -> int:
    """Bytes of a packed block-quantized tensor: code words plus one
    (float32 zero, float32 range) pair per block (paper Table 1, M)."""
    n = 1
    for s in shape:
        n *= s
    n_blocks = (n + group_size - 1) // group_size
    return 4 * n_blocks * packed_len(group_size, bits) + 8 * n_blocks
