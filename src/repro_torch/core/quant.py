"""Block-wise stochastic-rounding quantization (paper section 2, 3.1, 3.2).

The plain PyTorch version of the reference's ``repro.core.quant``; the CUDA
kernels in :mod:`repro_torch.kernels.quant_blockwise` must agree with it bit
for bit.  A tensor is flattened into blocks of ``group_size`` elements; each
block stores ``zero = min`` and ``range = max - min``, is normalized to
``[0, B]`` (``B = 2**bits - 1``) and stochastically rounded onto the level
table (integers ``0..B``, or the variance-minimized levels).

Division is always by a tensor, never by a python scalar: on CUDA, PyTorch
turns ``t / scalar`` into ``t * (1 / scalar)``, which can differ from the
reference's true division in the last bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32, hash_u32, uniform_from_counter

#: Shared clamp constant for zero-width ranges / bins (the reference's EPS).
EPS = 1e-10


def uniform_levels(bits: int, device=None) -> torch.Tensor:
    """EXACT's integer quantization levels 0..B."""
    return torch.arange(2**bits, dtype=torch.float32, device=device)


def group_reshape(x: torch.Tensor, group_size: int) -> tuple[torch.Tensor, int]:
    """Flatten ``x`` and regroup into (n_blocks, group_size) (paper Eq. 6).

    The tail is padded by replicating the last element, which cannot widen
    the final block's [min, max] envelope; returns (blocks, n_valid)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % group_size
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    return flat.reshape(-1, group_size), n


def block_stats(blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(zero, range) per block, the raw stats exactly as stored."""
    zero = blocks.amin(dim=-1)
    rng = blocks.amax(dim=-1) - zero
    return zero, rng


def _sr(hnorm: torch.Tensor, levels: torch.Tensor,
        u: torch.Tensor) -> torch.Tensor:
    """Round each ``hnorm`` up with probability ``p_up`` given noise ``u``."""
    nlev = levels.shape[0]
    upper_idx = torch.searchsorted(levels, hnorm.contiguous(), right=True)
    upper_idx = upper_idx.clamp(1, nlev - 1)
    lo = levels[upper_idx - 1]
    hi = levels[upper_idx]
    p_up = (hnorm - lo) / (hi - lo).clamp_min(EPS)
    return torch.where(u < p_up, upper_idx, upper_idx - 1).to(torch.int32)


def stochastic_round_per_run(hnorm: torch.Tensor, levels: torch.Tensor,
                             seeds: torch.Tensor, rows_per_seed: int
                             ) -> torch.Tensor:
    """SR of (n, G) normalized blocks where each run of ``rows_per_seed``
    rows has its own seed (``seeds`` (n / rows_per_seed,)) and a counter
    that restarts at 0: element (r, c) draws ``uniform(seeds[r // rps],
    (r % rps) * G + c)``, exactly what quantizing each run alone draws."""
    n, g = hnorm.shape
    row = torch.arange(n, dtype=torch.int64, device=hnorm.device)[:, None]
    col = torch.arange(g, dtype=torch.int64, device=hnorm.device)[None, :]
    counter = ((row % rows_per_seed) * g + col) & MASK32
    seed_rows = (seeds.to(torch.int64) & MASK32).repeat_interleave(
        rows_per_seed)[:, None]
    return _sr(hnorm, levels, uniform_from_counter(seed_rows, counter))


def stochastic_round_to_levels(hnorm: torch.Tensor, levels: torch.Tensor,
                               seed: int, counter_base: int = 0, *,
                               index0: int = 0) -> torch.Tensor:
    """SR of normalized activations in [0, B] onto ``levels`` (paper Eq. 8).

    Returns int32 codes (indices into ``levels``).  ``counter_base`` (a
    python int, may exceed 2**32) offsets the per-element counter: the
    64-bit counter ``counter_base + index`` is carried as (low word, high
    word), the low word feeding the hash as the counter and the high word
    (with the per-element carry) folded into the seed through the hash.
    ``hash(0) == 0``, so base 0 is the kernels' plain path.  ``index0``
    is the global index of element 0 when ``hnorm`` is a shard of a larger
    tensor: the counter is ``(index0 + index) mod 2**32``, as the
    unsharded call would draw it.
    """
    base_hi, base_lo = divmod(int(counter_base), 1 << 32)
    idx = (torch.arange(hnorm.numel(), dtype=torch.int64,
                        device=hnorm.device).reshape(hnorm.shape)
           + index0) & MASK32
    counter = (idx + base_lo) & MASK32
    carry = (counter < base_lo).to(torch.int64)
    hi_word = ((base_hi & MASK32) + carry) & MASK32
    seed_t = (int(seed) & MASK32) ^ hash_u32(hi_word)
    return _sr(hnorm, levels, uniform_from_counter(seed_t, counter))


def _level_table(levels, bits: int, device) -> torch.Tensor:
    if levels is None:
        return uniform_levels(bits, device)
    return torch.as_tensor(levels, dtype=torch.float32, device=device)


def global_blocks(n: int, row0: int = 0, block_stride=None,
                  device="cpu") -> torch.Tensor:
    """The global block index (int64, mod 2**32) of each of ``n`` local
    blocks: ``row0`` is local block 0's, and ``block_stride = (local,
    global)`` says the local blocks come in rows of ``local`` blocks that
    lie ``global`` blocks apart in the unsharded tensor (a column split:
    local row r's blocks start at ``row0 + r * global``).  Without a
    stride (or with ``local == global``) the blocks are one contiguous run
    from ``row0``."""
    b = torch.arange(n, dtype=torch.int64, device=device)
    if block_stride is not None:
        local, glob = (int(v) for v in block_stride)
        b = (b // local) * glob + b % local
    return (b + int(row0)) & MASK32


def quantize_grouped(blocks: torch.Tensor, bits: int, seed, levels=None, *,
                     rows_per_seed: int | None = None, row0: int = 0,
                     block_stride=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (n_blocks, G) -> (codes int32, zero f32, range f32).

    ``seed`` is a python int, or with ``rows_per_seed`` a tensor of one
    seed per run of rows (:func:`stochastic_round_per_run`).  ``row0`` and
    ``block_stride`` place the rows among the global blocks
    (:func:`global_blocks`): a shard's rows draw the noise of the
    unsharded call's."""
    lv = _level_table(levels, bits, blocks.device)
    B = float(2**bits - 1)
    zero, rng = block_stats(blocks)
    safe = rng.clamp_min(EPS)
    hnorm = ((blocks - zero[:, None]) / safe[:, None] * B).clamp(0.0, B)
    if rows_per_seed is None:
        n, g = blocks.shape
        index0 = row0 * g
        if block_stride is not None:
            # each row's counter starts at its global block's first element
            gb = global_blocks(n, row0, block_stride, blocks.device)
            index0 = (gb * g - torch.arange(n, dtype=torch.int64,
                                            device=blocks.device) * g)[:, None]
        codes = stochastic_round_to_levels(hnorm, lv, seed, index0=index0)
    else:
        if row0 or block_stride is not None:
            raise ValueError("row0 offsets the one-seed stream; a seed "
                             "table restarts its counter every run")
        codes = stochastic_round_per_run(hnorm, lv, seed, rows_per_seed)
    return codes, zero, rng


def dequantize_grouped(codes: torch.Tensor, zero: torch.Tensor,
                       rng: torch.Tensor, bits: int, levels=None
                       ) -> torch.Tensor:
    """Inverse of :func:`quantize_grouped` (paper Eq. 3 with level table)."""
    lv = _level_table(levels, bits, codes.device)
    B = rng.new_tensor(float(2**bits - 1))
    vals = lv[codes.to(torch.int64)]
    return vals * (rng[:, None] / B) + zero[:, None]


def quantize(x: torch.Tensor, bits: int, group_size: int, seed, levels=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Block-wise quantize a tensor of any shape: (codes (n_blocks, G)
    int32, zero, range, n_valid), over :func:`group_reshape`."""
    blocks, n_valid = group_reshape(x, group_size)
    codes, zero, rng = quantize_grouped(blocks, bits, seed, levels)
    return codes, zero, rng, n_valid


def dequantize(codes: torch.Tensor, zero: torch.Tensor, rng: torch.Tensor,
               bits: int, shape: tuple[int, ...], levels=None,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`: the first ``prod(shape)`` values of the
    dequantized blocks, in ``shape`` and ``dtype``."""
    n = 1
    for s in shape:
        n *= s
    blocks = dequantize_grouped(codes, zero, rng, bits, levels)
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)
