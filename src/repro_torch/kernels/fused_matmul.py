"""Fused matmul + quantize / dequantize + matmul: the CUDA kernel wrappers.

Counterparts of the reference's ``matmul_quant_call`` /
``dequant_matmul_call`` (``repro/kernels/fused_matmul.py``).  The kernels are
in ``csrc/fused_matmul.cu``; beside each wrapper sits its plain PyTorch
version (:mod:`repro_torch.kernels.ref`), which a wrapper runs only for a
tensor on the CPU.  For a CUDA tensor a wrapper launches its kernel or
raises.  Each wrapper counts its launches in ``<wrapper>.launches``.

Each kernel has three compiled CTA configurations (``kFwd`` and
``kTiles`` in the source, :data:`FWD_CONFIGS` and :data:`TILES` here); the
caller names one by index, and the backward also its split count S.  A
wrapper called without them takes :func:`repro_torch.kernels.autotune.
resolve`'s choice: a cached measurement, else the roofline's pick, which
is the fixed rule :func:`fwd_index` / :func:`tile_index` /
:func:`splits` at every shape the port launches.

The backward splits its row contraction into S contiguous ranges, each
writing a (D, N) partial into scratch, and adds the partials in a fixed
pairwise order; for a given configuration and S a result is bit-identical
from call to call.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.pack import ragged_words
from repro_torch.core.prng import MASK32
from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
#: Most levels of a VM table the fused pair takes (a register-sized table,
#: bits <= 4; the quant kernels alone take up to 256).
MAX_LEVELS = 16
#: Dynamic shared memory one CTA of the forward may use on an H100 (bytes:
#: 227 KiB less the kernel's static level table).
MAX_SMEM = 232_448 - 64
#: The backward's row ranges aim at TARGET_CTAS CTAs over all of them, one
#: an SM (at most MAX_SPLITS ranges).
TARGET_CTAS, MAX_SPLITS = 128, 64
#: Rows of x (and y) a forward CTA takes (``fwd::kBM``).
FWD_ROWS = 64
#: The forward's compiled CTA configurations (``kFwd``): (NT, WN, MT, KW,
#: S, MINB); a CTA takes ``8 * NT * WN`` columns of y (40, 64, 256), a
#: wider y several column slabs.
FWD_CONFIGS = ((5, 1, 1, 16, 2, 3), (8, 1, 1, 16, 4, 2), (8, 4, 2, 16, 2, 2))
#: The backward's compiled tiles (``kTiles``): (rows of dw, columns, stash
#: rows a stage); a wider dw takes several column tiles.
TILES = ((128, 40, 64), (128, 64, 64), (64, 256, 32))


def fwd_columns(config: int) -> int:
    """Columns of y a forward CTA of ``config`` takes."""
    nt, wn = FWD_CONFIGS[config][:2]
    return 8 * nt * wn


def covers(columns: int, n: int, widest: int) -> bool:
    """A configuration of ``columns`` columns a CTA covers an n-column
    output when one CTA spans it, or when it is the widest (which steps
    over wider outputs in column slabs)."""
    return n <= columns or columns == widest


def fwd_index(n: int) -> int:
    """The fixed rule: the narrowest forward configuration covering n."""
    return next(i for i in range(len(FWD_CONFIGS))
                if n <= fwd_columns(i) or i == len(FWD_CONFIGS) - 1)


def tile_index(n: int) -> int:
    """The fixed rule: the narrowest backward tile covering n."""
    return next(i for i, t in enumerate(TILES)
                if n <= t[1] or i == len(TILES) - 1)


def tile(n: int, config: int | None = None) -> tuple[int, int, int]:
    """(rows of dw, columns, stash rows a stage) of the backward's CTA tile
    ``config`` (default: the fixed rule for an (M, n) gradient).  The
    kernel launches the same tile (``dequant_matmul_tile`` in
    ``csrc/fused_matmul.cu``, held equal by a ``gpu`` test)."""
    return TILES[tile_index(n) if config is None else config]


@functools.lru_cache(maxsize=None)
def _lib(defines: tuple = ()) -> ctypes.CDLL:
    """The kernels' library; ``defines``: a measurement build's (see
    ``scripts/kernel_times.py fused --parts``)."""
    lib = build.load("fused_matmul", defines)
    lib.matmul_quant.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_uint32, _P,
                                 ctypes.c_int, ctypes.c_int, _P]
    lib.dequant_matmul.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, _P, ctypes.c_int,
                                   ctypes.c_int, _P]
    lib.matmul_quant.restype = lib.dequant_matmul.restype = ctypes.c_int
    lib.dequant_matmul_tile.argtypes = [ctypes.c_int, _P]
    lib.dequant_matmul_tile.restype = None
    # the launches' dynamic shared memory by configuration (held to the
    # kernel contracts)
    lib.matmul_quant_smem.argtypes = [ctypes.c_int] * 4
    lib.matmul_quant_smem.restype = ctypes.c_longlong
    lib.dequant_matmul_smem.argtypes = [ctypes.c_int] * 6 + [_P]
    lib.dequant_matmul_smem.restype = None
    return lib


def splits(m: int, d: int, n: int, config: int | None = None,
           s: int | None = None) -> tuple[int, int]:
    """(S, rows per range) of the backward's row contraction for an (m, d)
    stash and an (m, n) gradient with tile ``config`` (default: the fixed
    rule); the scratch is ``S * d * n`` floats when ``S > 1``.  Ranges are
    whole stages of the tile: ``s`` asks for that many (the count that
    results may be lower), and by default ranges aim at TARGET_CTAS CTAs."""
    bd, bn, ks = tile(n) if config is None else TILES[config]
    steps = max(1, math.ceil(m / ks))
    if s is None:
        tiles = math.ceil(d / bd) * math.ceil(n / bn)
        s = min(MAX_SPLITS, steps, max(1, math.ceil(TARGET_CTAS / tiles)))
    rows = math.ceil(steps / s) * ks
    return max(1, math.ceil(m / rows)), rows


def scratch_nbytes(m: int, d: int, n: int, config: int | None = None,
                   s: int | None = None) -> int:
    """Bytes of the backward's partials (0 when one range covers all rows)."""
    s, _ = splits(m, d, n, config, s)
    return 4 * s * d * n if s > 1 else 0


def unsupported(bits: int, group_size: int, levels) -> str | None:
    """Why the fused pair cannot take this config (None = it can): the
    reference's rule for its fused kernels, narrower than the quant
    kernels' own: ``bits`` divides 32, ``G`` is a multiple of the ``32 /
    bits`` codes a word holds (whole words), and a VM table has at most 16
    levels."""
    if 32 % bits:
        return f"bits={bits} does not divide 32"
    reason = ragged_words(group_size, bits)
    if reason is not None:
        return reason
    if levels is not None and len(levels) > MAX_LEVELS:
        return (f"VM table has {len(levels)} levels; the fused kernels take "
                f"at most {MAX_LEVELS} (bits <= 4)")
    return None


def _levels(bits: int, group_size: int, levels):
    reason = unsupported(bits, group_size, levels)
    if reason is not None:
        raise ValueError(f"CUDA fused kernel cannot run this config: {reason}")
    lv = (ctypes.c_float * MAX_LEVELS)(*(levels or ()))
    return lv, (0 if levels is None else len(levels))


def _stream() -> _P:
    return _P(torch.cuda.current_stream().cuda_stream)


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _aligned(name: str, m: int, d: int, g: int) -> None:
    """The pair's layout invariant (the routing's eligibility): blocks align
    to rows and the stash is whole blocks."""
    _need((d % g == 0 or g % d == 0) and (m * d) % g == 0,
          f"{name} needs whole blocks aligned to rows: D % G == 0 or "
          f"G % D == 0, and M * D % G == 0 (M={m}, D={d}, G={g})")


def matmul_quant(x2d: torch.Tensor, w: torch.Tensor, bits: int, seed: int,
                 levels=None, *, group_size: int, config: int | None = None):
    """``y = x @ w`` and the stash of ``x``: (y (M, N), packed int32
    (M*D/G, G*bits/32), zero (M*D/G,), rng (M*D/G,)), the stash bit-equal
    to ``quant_pack(x.reshape(-1, G))``.  ``config`` indexes
    :data:`FWD_CONFIGS` (default: :func:`repro_torch.kernels.autotune.
    resolve`'s)."""
    if not x2d.is_cuda:
        return ref.matmul_quantize_packed(x2d, w, bits, seed, levels,
                                          group_size=group_size)
    g = group_size
    _need(x2d.dtype == torch.float32 and w.dtype == torch.float32
          and x2d.dim() == 2 and w.dim() == 2 and w.is_cuda
          and x2d.shape[1] == w.shape[0],
          f"matmul_quant needs float32 x (M, D) and w (D, N) on the card, "
          f"got {x2d.dtype} {tuple(x2d.shape)} and {w.dtype} "
          f"{tuple(w.shape)}")
    _need(x2d.is_contiguous() and w.is_contiguous(),
          "matmul_quant needs contiguous tensors")
    m, d = x2d.shape
    n = w.shape[1]
    lv, n_lv = _levels(bits, g, levels)
    _need(n > 0, "matmul_quant needs N > 0")
    _aligned("matmul_quant", m, d, g)
    _need(4 * (g + 2) <= MAX_SMEM,
          f"matmul_quant stages one block of G={g} floats in shared memory, "
          f"at most {MAX_SMEM // 4 - 2}")
    if config is None:
        from repro_torch.kernels import autotune

        (config,) = autotune.resolve("fwd", m, d, n, bits, g)
    _need(0 <= config < len(FWD_CONFIGS),
          f"matmul_quant: no compiled configuration {config}")
    nb = m * d // g
    dev = x2d.device
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    packed = torch.empty((nb, g * bits // 32), dtype=torch.int32, device=dev)
    zero = torch.empty((nb,), dtype=torch.float32, device=dev)
    rng = torch.empty((nb,), dtype=torch.float32, device=dev)
    if m:
        build.check(_lib().matmul_quant(
            x2d.data_ptr(), w.data_ptr(), y.data_ptr(), packed.data_ptr(),
            zero.data_ptr(), rng.data_ptr(), m, d, n, g, bits,
            int(seed) & MASK32, lv, n_lv, config, _stream()), "matmul_quant")
        matmul_quant.launches += 1
    return y, packed, zero, rng


def dequant_matmul(packed: torch.Tensor, zero: torch.Tensor,
                   rng: torch.Tensor, g2d: torch.Tensor, bits: int,
                   group_size: int, d: int, levels=None, *,
                   config: int | None = None,
                   n_splits: int | None = None) -> torch.Tensor:
    """``dw = dequant(packed)^T @ g`` (d, N) for the stash of an (M, d)
    input and its (M, N) output gradient ``g2d``, with tile ``config`` of
    :data:`TILES` over ``n_splits`` row ranges (default:
    :func:`repro_torch.kernels.autotune.resolve`'s)."""
    if not packed.is_cuda:
        return ref.dequant_matmul_packed(packed, zero, rng, g2d, bits,
                                         group_size, d, levels)
    nb = packed.shape[0]
    _need(packed.dtype == torch.int32 and packed.dim() == 2
          and packed.shape[1] * 32 == group_size * bits
          and zero.dtype == torch.float32 and rng.dtype == torch.float32
          and zero.shape == (nb,) and rng.shape == (nb,),
          "dequant_matmul needs int32 words (n, G*bits/32) and float32 "
          "zero/rng (n,)")
    _need(g2d.dtype == torch.float32 and g2d.dim() == 2 and g2d.is_cuda,
          f"dequant_matmul needs a float32 (M, N) gradient on the card, got "
          f"{g2d.dtype} {tuple(g2d.shape)}")
    m, n = g2d.shape
    _need(nb * group_size == m * d,
          f"dequant_matmul: {nb} blocks of {group_size} are not an "
          f"({m}, {d}) stash")
    _aligned("dequant_matmul", m, d, group_size)
    _need(all(t.is_contiguous() for t in (packed, zero, rng, g2d)),
          "dequant_matmul needs contiguous tensors")
    lv, n_lv = _levels(bits, group_size, levels)
    dw = torch.empty((d, n), dtype=torch.float32, device=g2d.device)
    if m == 0 or d == 0 or n == 0:
        return dw.zero_()
    if config is None:
        from repro_torch.kernels import autotune

        config, n_splits = autotune.resolve("bwd", m, d, n, bits, group_size)
    _need(0 <= config < len(TILES),
          f"dequant_matmul: no compiled tile {config}")
    s, rows = splits(m, d, n, config, n_splits)
    part = (torch.empty((s, d, n), dtype=torch.float32, device=g2d.device)
            if s > 1 else dw)
    build.check(_lib().dequant_matmul(
        packed.data_ptr(), zero.data_ptr(), rng.data_ptr(), g2d.data_ptr(),
        part.data_ptr(), dw.data_ptr(), m, d, n, s, rows, group_size, bits,
        lv, n_lv, config, _stream()), "dequant_matmul")
    dequant_matmul.launches += 1
    return dw


matmul_quant.launches = 0
dequant_matmul.launches = 0
