"""Seeded Rademacher random-projection matmul: the CUDA kernel wrappers.

Counterparts of the reference's ``rp_project_call`` / ``irp_project_call``
(``repro/kernels/rp_matmul.py``): ``x @ R(seed)`` and ``x @ R(seed)^T`` with
R regenerated inside the kernel (``csrc/rp_matmul.cu``) and never stored.
A wrapper runs its plain PyTorch version (:mod:`repro_torch.kernels.ref`)
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.prng import MASK32
from repro_torch.core.random_projection import rp_scale
from repro_torch.kernels import build, ref

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("rp_matmul")
    lib.rp_project.argtypes = [_P, _P, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_uint32, ctypes.c_float, _P]
    lib.rp_project.restype = ctypes.c_int
    return lib


def _launch(x2d: torch.Tensor, seed: int, n_out: int, r_dim: int,
            transpose: bool) -> torch.Tensor:
    if x2d.dtype != torch.float32 or x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError(f"rp kernels need a contiguous 2-D float32 tensor, "
                         f"got {x2d.dtype} {tuple(x2d.shape)}")
    m, k = x2d.shape
    out = torch.empty((m, n_out), dtype=torch.float32, device=x2d.device)
    if m and n_out:
        build.check(_lib().rp_project(
            x2d.data_ptr(), out.data_ptr(), m, k, n_out, r_dim,
            int(transpose), int(seed) & MASK32, rp_scale(r_dim),
            _P(torch.cuda.current_stream().cuda_stream)), "rp_project")
    return out


def rp_project(x2d: torch.Tensor, seed: int, d_out: int) -> torch.Tensor:
    """x (M, D) @ R(seed) (D, d_out); R normalized by 1/sqrt(d_out)."""
    if not x2d.is_cuda:
        return ref.rp_project(x2d, seed, d_out)
    out = _launch(x2d, seed, d_out, d_out, transpose=False)
    rp_project.launches += 1
    return out


def irp_project(x2d: torch.Tensor, seed: int, d_in: int) -> torch.Tensor:
    """x (M, r) @ R(seed)^T (r, d_in); the same R as the forward projection."""
    if not x2d.is_cuda:
        return ref.irp_project(x2d, seed, d_in)
    out = _launch(x2d, seed, d_in, x2d.shape[1], transpose=True)
    irp_project.launches += 1
    return out


rp_project.launches = 0
irp_project.launches = 0
