"""Flash attention: the CUDA kernel wrapper.

Counterpart of the reference's ``flash_attention_call``
(``repro/kernels/flash_attention.py``), extended to what the reference's
``models.attention.online_attention`` computes on the prefill path: a query
offset, a count of valid keys, and the choice of where the scale applies.
The kernel is in ``csrc/flash_attention.cu``; its plain PyTorch version is
:func:`repro_torch.kernels.ref.flash_attention`, which the wrapper runs only
for a tensor on the CPU.  For a CUDA tensor it launches the kernel or
raises.  Launches are counted in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, ctypes.c_float, _I, _P]
    lib.flash_attention.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
           q_offset: int) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention needs q, k and v of one dtype")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention needs q (BH, Sq, Dh) and k, v "
                         f"(BH, Skv, Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes d_head in "
                         f"{HEAD_DIMS}, got {q.shape[2]}")
    if q.shape[0] > 65_535:
        raise ValueError(f"B*H = {q.shape[0]} exceeds the grid's 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous tensors")
    if not 1 <= kv_len <= k.shape[1] or q_offset < 0:
        raise ValueError(f"flash_attention needs 1 <= kv_len <= Skv and "
                         f"q_offset >= 0; got kv_len={kv_len}, "
                         f"q_offset={q_offset}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: int | None = None, scale: float | None = None,
                    scale_q: bool = False) -> torch.Tensor:
    """Softmax attention of q (BH, Sq, Dh) over k, v (BH, Skv, Dh), float32
    sums inside, output in q's dtype.  On the card, float32 inputs run a
    SIMT float32 kernel; bf16 inputs run the tensor cores, with P split
    into two bf16 parts so the result keeps the float32 band.

    ``q_offset`` is the absolute position of query row 0 (causal masking
    keeps key j for query i when ``j <= q_offset + i``); ``kv_len`` counts
    the valid keys (default Skv); ``scale`` defaults to ``1/sqrt(Dh)``.
    ``scale_q`` scales q in float32 before the product (the reference's
    ``online_attention`` order) instead of the scores after it (the Pallas
    kernel's order).  The bf16 kernel scales the scores in both orders:
    its products are exact in float32, so the two differ by a few float32
    ulps of a score."""
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len, scale=scale,
                                   scale_q=scale_q)
    bh, sq, _ = q.shape
    skv = k.shape[1]
    kv_len = skv if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len, int(q_offset))
    out = torch.empty_like(q)
    if sq:
        build.check(_lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            skv, dh, int(q.dtype == torch.bfloat16), int(causal),
            int(q_offset), kv_len, scale, int(scale_q),
            _P(torch.cuda.current_stream().cuda_stream)), "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
