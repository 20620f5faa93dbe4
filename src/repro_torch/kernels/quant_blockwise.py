"""Block-wise quantize+pack / unpack+dequantize: the CUDA kernel wrappers.

Counterparts of the reference's ``quant_pack_call`` / ``dequant_unpack_call``
(``repro/kernels/quant_blockwise.py``).  The kernels are in
``csrc/quant_blockwise.cu``; beside each wrapper sits its plain PyTorch
version (:mod:`repro_torch.kernels.ref`), which a wrapper runs only for a
tensor on the CPU.  For a CUDA tensor a wrapper launches its kernel or
raises.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import pack as packmod
from repro_torch.core.prng import MASK32
from repro_torch.kernels import build, ref

#: Most levels of a VM table the kernels take: 256, an 8-bit table (tables
#: of up to 16 levels stay in the vector path's registers; larger ones go
#: to the scalar path's shared-memory table).
MAX_LEVELS = 256
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("quant_blockwise")
    lib.quant_pack.argtypes = [_P, _P, _P, _P, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                               _P, ctypes.c_int, ctypes.c_uint32,
                               ctypes.c_uint32, ctypes.c_uint32, _P,
                               ctypes.c_int, _P]
    lib.dequant_unpack.argtypes = [_P, _P, _P, _P, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, _P,
                                   ctypes.c_int, _P]
    lib.quant_lanes_per_block.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.quant_pack.restype = lib.dequant_unpack.restype = ctypes.c_int
    lib.quant_lanes_per_block.restype = ctypes.c_int
    return lib


def lanes_per_block(group_size: int, bits: int) -> int:
    """Lanes of the kernels' vector path that take one block (``G / 16``,
    four 16-byte chunks a lane), or 0 where the kernels take their scalar
    path (one warp a block): the vector path takes ``G`` of 64, 128 or 256
    whose words are whole 16-byte groups (``G * bits`` a multiple of 128),
    with 16-byte aligned inputs and outputs.  The rule of
    ``quant_lanes_per_block`` in ``csrc/quant_blockwise.cu``."""
    if group_size not in (64, 128, 256) or group_size * bits % 128:
        return 0
    return group_size // 16


def unsupported(bits: int, group_size: int, levels) -> str | None:
    """Why the kernels cannot take this config (None = they can): ``bits``
    must divide 32 and a VM table hold at most 256 levels.  Any group size
    runs: one that is not a multiple of the ``32 / bits`` codes a word
    holds packs into ``ceil(G * bits / 32)`` words whose spare fields are
    zero (the reference's pack layout)."""
    if 32 % bits:
        return f"bits={bits} does not divide 32"
    if levels is not None and len(levels) > MAX_LEVELS:
        return (f"VM table has {len(levels)} levels; the kernels take at "
                f"most {MAX_LEVELS} (bits <= 8)")
    return None


def _checked(bits: int, group_size: int, levels, *tensors) -> tuple:
    reason = unsupported(bits, group_size, levels)
    if reason is not None:
        raise ValueError(f"CUDA quant kernel cannot run this config: {reason}")
    if group_size < 1:
        raise ValueError(f"group_size={group_size} must be positive")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("CUDA quant kernels need contiguous tensors")
    levels = levels or ()
    return (ctypes.c_float * max(1, len(levels)))(*levels), len(levels)


def _stream() -> _P:
    return _P(torch.cuda.current_stream().cuda_stream)


def _seed_run_length(seed, n: int, rows_per_seed: int | None) -> int:
    """Check a per-run seed table against ``n`` block rows; returns the run
    length (rows per seed).  ``seed`` is a python int (one stream, no
    table) or a 1-D integer tensor of ``n / rows_per_seed`` uint32 seeds."""
    if not isinstance(seed, torch.Tensor):
        if rows_per_seed is not None:
            raise ValueError("rows_per_seed needs a tensor of seeds")
        return 0
    if rows_per_seed is None or rows_per_seed < 1 or n % rows_per_seed \
            or seed.shape != (n // rows_per_seed,) \
            or seed.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"a seed table must be a 1-D integer tensor of one "
                         f"seed per {rows_per_seed} of the {n} rows, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    return rows_per_seed


def offset_unsupported(n_blocks: int, row0: int = 0, block_stride=None,
                       seeded: bool = False) -> str | None:
    """Why ``quant_pack`` cannot take this block offset (None = it can):
    a stride ``(local, global)`` needs ``1 <= local <= global`` and whole
    local rows (``local`` divides the block count), and a seed table
    takes no offset (its counter restarts every run).  The rule of
    ``quant_pack``'s argument check in ``csrc/quant_blockwise.cu``."""
    if block_stride is not None:
        local, glob = (int(v) for v in block_stride)
        if not 1 <= local <= glob or glob >= 1 << 32:
            return (f"block stride {block_stride}: need 1 <= blocks a "
                    f"local row <= blocks a global row < 2**32")
        if n_blocks % local:
            return (f"{n_blocks} blocks are not whole local rows of "
                    f"{local}")
    if seeded and (row0 or block_stride is not None):
        return ("row0 offsets the one-seed stream; a seed table restarts "
                "its counter every run")
    return None


def quant_pack(x2d: torch.Tensor, bits: int, seed, levels=None, *,
               rows_per_seed: int | None = None, row0: int = 0,
               block_stride=None):
    """(n_blocks, G) f32 -> (packed int32 (n, ceil(G*bits/32)), zero (n,),
    rng (n,)).

    ``seed`` is a python int: element (row, col) draws its SR noise from
    counter ``row * G + col``.  Or it is a tensor of one seed per run of
    ``rows_per_seed`` rows, on the input's device: row r takes
    ``seed[r // rows_per_seed]`` and counter ``(r % rows_per_seed) * G +
    col`` (each run quantized as if alone, as the serving KV cache
    quantizes each token).

    ``row0`` (one seed only) is the global block index of row 0: a shard
    of a larger input draws counter ``(row0 + row) * G + col`` (mod
    2**32), so its words are the unsharded call's rows bit for bit.
    ``block_stride = (local, global)`` is a column split's: the rows come
    in local rows of ``local`` blocks, ``global`` blocks apart in the
    unsharded tensor, so row ``row`` is global block ``row0 + (row //
    local) * global + row % local``
    (:func:`repro_torch.core.quant.global_blocks`)."""
    rps = _seed_run_length(seed, x2d.shape[0], rows_per_seed)
    reason = offset_unsupported(x2d.shape[0], row0, block_stride, bool(rps))
    if reason is not None:
        raise ValueError(reason)
    if not x2d.is_cuda:
        return ref.quantize_packed(x2d, bits, seed, levels,
                                   rows_per_seed=rows_per_seed, row0=row0,
                                   block_stride=block_stride)
    if x2d.dtype != torch.float32 or x2d.dim() != 2:
        raise ValueError(f"quant_pack needs a 2-D float32 tensor, got "
                         f"{x2d.dtype} {tuple(x2d.shape)}")
    n, g = x2d.shape
    lv, n_lv = _checked(bits, g, levels, x2d)
    seeds = None
    if rps:
        if seed.device != x2d.device:
            raise ValueError("the seed table must lie on the input's device")
        # uint32 values as int32 bits (the int64 -> int32 cast wraps)
        seeds = (seed.to(torch.int64) & MASK32).to(torch.int32).contiguous()
    packed = torch.empty((n, packmod.packed_len(g, bits)), dtype=torch.int32,
                         device=x2d.device)
    zero = torch.empty((n,), dtype=torch.float32, device=x2d.device)
    rng = torch.empty((n,), dtype=torch.float32, device=x2d.device)
    if n:
        build.check(_lib().quant_pack(
            x2d.data_ptr(), packed.data_ptr(), zero.data_ptr(),
            rng.data_ptr(), n, g, bits, 0 if rps else int(seed) & MASK32,
            None if seeds is None else seeds.data_ptr(), rps,
            int(row0) & MASK32, *(block_stride or (1, 1)), lv, n_lv,
            _stream()), "quant_pack")
        quant_pack.launches += 1
    return packed, zero, rng


def dequant_unpack(packed: torch.Tensor, zero: torch.Tensor,
                   rng: torch.Tensor, bits: int, group_size: int,
                   levels=None) -> torch.Tensor:
    """(packed (n, ceil(G*bits/32)), zero (n,), rng (n,)) -> (n, G) f32."""
    if not packed.is_cuda:
        return ref.dequantize_packed(packed, zero, rng, bits, group_size,
                                     levels)
    n = packed.shape[0]
    if (packed.dtype != torch.int32 or packed.dim() != 2
            or packed.shape[1] != packmod.packed_len(group_size, bits)
            or zero.dtype != torch.float32
            or rng.dtype != torch.float32 or zero.shape != (n,)
            or rng.shape != (n,)):
        raise ValueError("dequant_unpack needs int32 words (n, "
                         "ceil(G*bits/32)) and float32 zero/rng (n,)")
    lv, n_lv = _checked(bits, group_size, levels, packed, zero, rng)
    out = torch.empty((n, group_size), dtype=torch.float32,
                      device=packed.device)
    if n:
        build.check(_lib().dequant_unpack(
            packed.data_ptr(), zero.data_ptr(), rng.data_ptr(),
            out.data_ptr(), n, group_size, bits, lv, n_lv, _stream()),
            "dequant_unpack")
        dequant_unpack.launches += 1
    return out


quant_pack.launches = 0
dequant_unpack.launches = 0
