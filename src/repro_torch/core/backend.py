"""Kernel-backend dispatch for the compression stack.

Callers (``core.compressor`` and through it the GNN engine) name an
``impl`` and this layer routes:

  * ``"torch"`` -- the plain PyTorch versions (``repro_torch.kernels.ref``)
  * ``"cuda"``  -- the hand-written CUDA kernels
  * ``"auto"``  -- ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors

No fallback hides the device or a kernel: on CUDA a config the kernels do
not take raises, whether it was asked for by name or by ``"auto"``.  (The
reference's ``auto`` quietly falls back to jnp there; in the port the plain
path is only ever the CPU's.)  So the quant kernels take every config the
main path reaches: ragged words and VM tables of up to 256 levels, which
the reference's kernels leave to its jnp path.  The fused pair's
eligibility makes the reference's decisions for the same shapes, bits and
levels.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import quant as quantmod
from repro_torch.kernels import ops
from repro_torch.kernels.fused_matmul import (
    unsupported as fused_kernel_unsupported)
from repro_torch.kernels.ops import resolve_impl, static_levels
from repro_torch.kernels.quant_blockwise import (
    unsupported as quant_kernel_unsupported)

VALID_FUSED = ("auto", "on", "off")


@contextlib.contextmanager
def use_impl(impl: str | None):
    """Override every ``impl`` (a config's, or one named in a call) for the
    kernel calls made inside the context; ``None`` is a no-op.  The
    reference's override acts while a step is traced; this one acts while
    the calls run (it is a context variable read at each dispatch)."""
    if impl is None:
        yield
        return
    if impl not in ops.VALID_IMPLS:
        raise ValueError(f"impl={impl!r} not in {ops.VALID_IMPLS}")
    token = ops.IMPL_OVERRIDE.set(impl)
    try:
        yield
    finally:
        ops.IMPL_OVERRIDE.reset(token)


# ----------------------------------------------------------------- routing
def route_quant(impl: str, bits: int, group_size: int, levels=None,
                device="cpu") -> str:
    """Concrete impl for quantize/dequantize of tensors on ``device``.

    Raises when the CUDA kernels would be needed for a config they cannot
    run (see :func:`quant_kernel_unsupported`: ``32 % bits != 0``, or a VM
    table of more than 256 levels)."""
    concrete = resolve_impl(impl, device)
    if concrete == "torch":
        return "torch"
    reason = quant_kernel_unsupported(bits, group_size, static_levels(levels))
    if reason is not None:
        raise ValueError(f"impl={impl!r} on {device} needs the CUDA quant "
                         f"kernel, which cannot run this config: {reason}")
    return concrete


def fused_unsupported(shape, bits: int, group_size: int,
                      levels=None) -> str | None:
    """Why the fused matmul+quant pair cannot run this stash (None = it
    can): the fused kernels' own constraints hold (whole words and at most
    16 levels, narrower than the quant kernels'), the operand is 2-D, its
    blocks align to rows (``D % G == 0`` or ``G % D == 0``), and the element
    count is whole blocks (the fused pad cannot reproduce the replicate-
    padded ragged tail)."""
    reason = fused_kernel_unsupported(bits, group_size, static_levels(levels))
    if reason is not None:
        return reason
    if len(shape) != 2:
        return f"fused matmul needs a 2-D operand, got shape {shape}"
    m, d = int(shape[0]), int(shape[1])
    if d % group_size and group_size % d:
        return (f"blocks (G={group_size}) straddle rows of width {d}: "
                "need D % G == 0 or G % D == 0")
    if (m * d) % group_size:
        return (f"{m}x{d} is not whole blocks of {group_size} (the ragged "
                "tail needs the reference replicate-padding)")
    return None


def supports_fused(shape, bits: int, group_size: int, levels=None) -> bool:
    """Boolean face of :func:`fused_unsupported`."""
    return fused_unsupported(shape, bits, group_size, levels) is None


def route_fused(fused: str, impl: str, shape, bits: int, group_size: int,
                levels=None, rp_ratio: int = 0, device="cpu") -> str | None:
    """Concrete impl of the fused matmul-quant pair for tensors on
    ``device``, or None for the unfused two-pass spelling.

    The reference's decisions: ``"off"`` never fuses.  ``"on"`` raises
    ``ValueError`` on an ineligible config (see :func:`fused_unsupported`)
    or on ``rp_ratio > 1``, and otherwise returns the concrete impl:
    ``"torch"`` on the CPU (the plain composition, the same bits) and
    ``"cuda"`` on the card.  ``"auto"`` fuses only on the kernel path: an
    eligible layer with ``rp_ratio <= 1`` on a CUDA device gets ``"cuda"``,
    everything else None (on the card the unfused spelling still runs the
    quant kernels; on the CPU ``"auto"`` declines, as the reference's
    ``"auto"`` does off the TPU)."""
    if fused not in VALID_FUSED:
        raise ValueError(f"fused={fused!r} not in {VALID_FUSED}")
    concrete = resolve_impl(impl, device)
    if fused == "off":
        return None
    reason = fused_unsupported(shape, bits, group_size, levels)
    if reason is None and rp_ratio > 1:
        reason = (f"rp_ratio={rp_ratio} projects before quantization; the "
                  "fused epilogue quantizes the matmul operand itself")
    if fused == "on":
        if reason is not None:
            raise ValueError(f"fused='on' cannot run this config: {reason}")
        return concrete
    if reason is not None or concrete != "cuda":
        return None
    return concrete


def route_rp(impl: str, device="cpu") -> str:
    """Concrete impl for RP/IRP.  The CUDA kernel masks its own ragged
    edges, so unlike the reference (whose TPU kernel needs D and r to be
    multiples of its 128 x 128 tile) every shape takes the kernel."""
    return resolve_impl(impl, device)


# ------------------------------------------------------------ block helpers
def to_blocks(x: torch.Tensor, group_size: int) -> tuple[torch.Tensor, int]:
    """Flatten + regroup into (n_blocks, G) with replicate tail padding
    (the last element repeated: it cannot widen the final block's
    [min, max] envelope, where zeros would)."""
    return quantmod.group_reshape(x, group_size)


def from_blocks(blocks: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Drop tail padding and restore the original shape."""
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape)


# -------------------------------------------------------------- primitives
def quantize_blocks(blocks, bits: int, seed: int, levels=None, *,
                    impl: str = "auto", row0: int = 0, block_stride=None):
    """(n_blocks, G) f32 -> (packed int32, zero (n,), rng (n,)); ``row0``
    is the global block index of row 0, ``block_stride`` (blocks a local
    row, blocks a global row) a column split's stride."""
    return ops.quantize_packed(blocks, bits, seed, levels, impl=impl,
                               row0=row0, block_stride=block_stride)


def dequantize_blocks(packed, zero, rng, bits: int, group_size: int,
                      levels=None, *, impl: str = "auto"):
    """(packed, zero (n,), rng (n,)) -> (n_blocks, G) f32."""
    return ops.dequantize_packed(packed, zero, rng, bits, group_size, levels,
                                 impl=impl)


def rp(x, seed: int, d_out: int, *, impl: str = "auto"):
    """Project the last dim D -> d_out (any leading rank)."""
    d_in = x.shape[-1]
    out = ops.rp_project(x.reshape(-1, d_in), seed, d_out, impl=impl)
    return out.reshape(*x.shape[:-1], d_out)


def irp(x, seed: int, d_in: int, *, impl: str = "auto"):
    """Recover the last dim r -> d_in (any leading rank)."""
    r = x.shape[-1]
    out = ops.irp_project(x.reshape(-1, r), seed, d_in, impl=impl)
    return out.reshape(*x.shape[:-1], d_in)


def matmul_quantize(x2d, w, bits: int, seed: int, levels=None, *,
                    impl: str, group_size: int):
    """Fused ``y = x @ w`` + quantize/pack ``x`` beside it.  ``impl`` is the
    concrete impl :func:`route_fused` returned."""
    return ops.matmul_quantize_packed(x2d, w, bits, seed, levels,
                                      group_size=group_size, impl=impl)


def dequant_matmul(packed, zero, rng, g2d, bits: int, group_size: int,
                   d: int, levels=None, *, impl: str):
    """Fused ``dw = dequant(packed)^T @ g`` (dequantize in the backward
    matmul's prologue)."""
    return ops.dequant_matmul_packed(packed, zero, rng, g2d, bits,
                                     group_size, d, levels, impl=impl)
