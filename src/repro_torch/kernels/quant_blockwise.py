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

from repro_torch.core.prng import MASK32
from repro_torch.kernels import build, ref

MAX_LEVELS = 16
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("quant_blockwise")
    lib.quant_pack.argtypes = [_P, _P, _P, _P, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                               _P, ctypes.c_int, _P]
    lib.dequant_unpack.argtypes = [_P, _P, _P, _P, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, _P,
                                   ctypes.c_int, _P]
    lib.quant_pack.restype = lib.dequant_unpack.restype = ctypes.c_int
    return lib


def unsupported(bits: int, group_size: int, levels) -> str | None:
    """Why the kernels cannot take this config (None = they can)."""
    if 32 % bits:
        return f"bits={bits} does not divide 32"
    vpw = 32 // bits
    if group_size % vpw:
        return (f"group_size={group_size} is not a multiple of the "
                f"{vpw} codes-per-word pack width")
    if levels is not None and len(levels) > MAX_LEVELS:
        return (f"VM table has {len(levels)} levels; the kernel supports "
                f"at most {MAX_LEVELS} (bits <= 4)")
    return None


def _checked(bits: int, group_size: int, levels, *tensors) -> tuple:
    reason = unsupported(bits, group_size, levels)
    if reason is not None:
        raise ValueError(f"CUDA quant kernel cannot run this config: {reason}")
    if 8 * group_size * 4 > 232_448:
        raise ValueError(f"group_size={group_size} needs more shared memory "
                         "than a CTA has")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("CUDA quant kernels need contiguous tensors")
    lv = (ctypes.c_float * MAX_LEVELS)(*(levels or ()))
    return lv, (0 if levels is None else len(levels))


def _stream() -> _P:
    return _P(torch.cuda.current_stream().cuda_stream)


def quant_pack(x2d: torch.Tensor, bits: int, seed: int, levels=None):
    """(n_blocks, G) f32 -> (packed int32 (n, G*bits/32), zero (n,), rng (n,))."""
    if not x2d.is_cuda:
        return ref.quantize_packed(x2d, bits, seed, levels)
    if x2d.dtype != torch.float32 or x2d.dim() != 2:
        raise ValueError(f"quant_pack needs a 2-D float32 tensor, got "
                         f"{x2d.dtype} {tuple(x2d.shape)}")
    n, g = x2d.shape
    lv, n_lv = _checked(bits, g, levels, x2d)
    packed = torch.empty((n, g * bits // 32), dtype=torch.int32,
                         device=x2d.device)
    zero = torch.empty((n,), dtype=torch.float32, device=x2d.device)
    rng = torch.empty((n,), dtype=torch.float32, device=x2d.device)
    if n:
        build.check(_lib().quant_pack(
            x2d.data_ptr(), packed.data_ptr(), zero.data_ptr(),
            rng.data_ptr(), n, g, bits, int(seed) & MASK32, lv, n_lv,
            _stream()), "quant_pack")
        quant_pack.launches += 1
    return packed, zero, rng


def dequant_unpack(packed: torch.Tensor, zero: torch.Tensor,
                   rng: torch.Tensor, bits: int, group_size: int,
                   levels=None) -> torch.Tensor:
    """(packed (n, W), zero (n,), rng (n,)) -> (n, G) f32."""
    if not packed.is_cuda:
        return ref.dequantize_packed(packed, zero, rng, bits, group_size,
                                     levels)
    n = packed.shape[0]
    if (packed.dtype != torch.int32 or packed.shape[1] * 32 // bits
            != group_size or zero.dtype != torch.float32
            or rng.dtype != torch.float32 or zero.shape != (n,)
            or rng.shape != (n,)):
        raise ValueError("dequant_unpack needs int32 words (n, G*bits/32) "
                         "and float32 zero/rng (n,)")
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
