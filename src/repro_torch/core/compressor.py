"""User-facing compression API: config + compress/decompress.

``CompressedTensor`` is the stored form of an activation map: densely packed
codes + per-block (zero, range) + the RP seed if random projection was used.
Execution strategy is owned by :mod:`repro_torch.core.backend`; this module
is the orchestrator: RP -> quantize+pack on the way in, unpack+dequantize ->
IRP on the way back.  Seeds are python ints taken mod 2**32, so no device
value is ever read back to choose a stream.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backend
from repro_torch.core.prng import MASK32
from repro_torch.core.variance import optimize_levels

#: XOR salt deriving a stash's RP seed from its SR seed.
RP_SEED_SALT = 0xA5A5_A5A5


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """How to compress an activation map.

    bits        quantization precision (2 = the paper's INT2 setting)
    group_size  elements per quantization block (paper section 3.1)
    rp_ratio    D/R random-projection ratio (paper uses 8); 0 disables RP
    vm          use variance-minimized non-uniform levels (paper 3.2)
    vm_dim      D of the CN_[1/D] level model; None = the post-RP block
                size ``group_size // rp_ratio`` (paper App. C)
    impl        kernel backend: "auto" | "torch" | "cuda"
    """

    bits: int = 2
    group_size: int = 256
    rp_ratio: int = 0
    vm: bool = False
    vm_dim: int | None = None
    impl: str = "auto"

    def cn_dim(self) -> int:
        """The D parameter of the CN_[1/D] activation model (clamped to 2)."""
        if self.vm_dim is not None:
            if self.vm_dim < 2:
                raise ValueError(
                    f"vm_dim must be >= 2 (CN_[1/D] needs 1/D < 1/2), got "
                    f"{self.vm_dim}")
            return int(self.vm_dim)
        d = (self.group_size // self.rp_ratio if self.rp_ratio > 1
             else self.group_size)
        return max(int(d), 2)

    def levels(self) -> tuple[float, ...] | None:
        if not self.vm:
            return None
        return optimize_levels(self.cn_dim(), self.bits)

    def with_impl(self, impl: str) -> "CompressionConfig":
        """Same compression scheme on a different kernel backend."""
        return dataclasses.replace(self, impl=impl)


@dataclasses.dataclass
class CompressedTensor:
    packed: torch.Tensor       # (n_blocks, words_per_block) int32 bit-views
    zero: torch.Tensor         # (n_blocks,) f32
    rng: torch.Tensor          # (n_blocks,) f32
    rp_seed: torch.Tensor      # () int32 bit-view of the uint32 RP seed
    shape: tuple[int, ...]     # original (pre-RP) shape
    dtype: torch.dtype
    cfg: CompressionConfig

    @property
    def nbytes(self) -> int:
        """Exact stored bytes of every child tensor (``rp_seed`` included),
        so ``graph.analysis.saved_bytes_per_layer`` agrees to the byte."""
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.zero, self.rng, self.rp_seed))

    @property
    def seed(self) -> int:
        """The RP seed as a python int (``rp_seed`` stays on the host, so
        reading it costs no device sync)."""
        return int(self.rp_seed) & MASK32


def _proj_shape(shape: tuple[int, ...], rp_ratio: int) -> tuple[int, ...]:
    if rp_ratio <= 1:
        return shape
    d = shape[-1]
    if d % rp_ratio:
        raise ValueError(f"last dim {d} not divisible by rp_ratio {rp_ratio}")
    return (*shape[:-1], d // rp_ratio)


def _seed_tensor(seed: int) -> torch.Tensor:
    s = seed & MASK32
    return torch.tensor(s - (1 << 32) if s >= 1 << 31 else s,
                        dtype=torch.int32)


def compress(x: torch.Tensor, cfg: CompressionConfig,
             seed: int, row0: int = 0) -> CompressedTensor:
    """Forward-pass compression: (optional RP) -> block SR quant+pack, on
    the backend ``cfg.impl`` names for ``x``'s device.  ``row0`` is the
    global block index of ``x``'s first block when ``x`` is a shard of a
    larger tensor (its noise is then the unsharded stash's)."""
    seed = int(seed) & MASK32
    orig_shape, orig_dtype = tuple(x.shape), x.dtype
    rp_seed = seed ^ RP_SEED_SALT
    levels = cfg.levels()
    # refuse a config the CUDA kernels cannot take before any work is done
    backend.route_quant(cfg.impl, cfg.bits, cfg.group_size, levels, x.device)
    x = x.to(torch.float32)
    if cfg.rp_ratio > 1:
        x = backend.rp(x, rp_seed, x.shape[-1] // cfg.rp_ratio, impl=cfg.impl)
    blocks, _ = backend.to_blocks(x, cfg.group_size)
    packed, zero, rng = backend.quantize_blocks(blocks, cfg.bits, seed,
                                                levels, impl=cfg.impl,
                                                row0=row0)
    return CompressedTensor(packed, zero, rng, _seed_tensor(rp_seed),
                            shape=orig_shape, dtype=orig_dtype, cfg=cfg)


def decompress(ct: CompressedTensor) -> torch.Tensor:
    """Backward-pass recovery: unpack+dequant -> (optional IRP), on the
    backend ``ct.cfg.impl`` names for the codes' device."""
    cfg = ct.cfg
    blocks = backend.dequantize_blocks(ct.packed, ct.zero, ct.rng, cfg.bits,
                                       cfg.group_size, cfg.levels(),
                                       impl=cfg.impl)
    x = backend.from_blocks(blocks, _proj_shape(ct.shape, cfg.rp_ratio))
    if cfg.rp_ratio > 1:
        x = backend.irp(x, ct.seed, ct.shape[-1], impl=cfg.impl)
    return x.to(ct.dtype)


def compress_matmul(x: torch.Tensor, w: torch.Tensor, cfg: CompressionConfig,
                    seed: int, fused: str = "auto"
                    ) -> tuple[torch.Tensor, CompressedTensor]:
    """Forward matmul ``y = x @ w`` (f32) plus the stash ``ct`` of ``x``.

    :func:`repro_torch.core.backend.route_fused` decides: the fused pair
    (``x`` quantized beside the product, one read of ``x``) or, when it
    declines, the unfused two-pass spelling.  Either way ``ct`` holds the
    words :func:`compress` writes, and the same ``rp_seed``, shape, dtype
    and cfg, so ``ct.nbytes`` is the ledger's."""
    seed = int(seed) & MASK32
    levels = cfg.levels()
    concrete = backend.route_fused(fused, cfg.impl, tuple(x.shape), cfg.bits,
                                   cfg.group_size, levels, cfg.rp_ratio,
                                   x.device)
    if concrete is None:
        ct = compress(x, cfg, seed)
        return x.to(torch.float32) @ w.to(torch.float32), ct
    y, packed, zero, rng = backend.matmul_quantize(
        x.to(torch.float32), w.to(torch.float32), cfg.bits, seed, levels,
        impl=concrete, group_size=cfg.group_size)
    ct = CompressedTensor(packed, zero, rng, _seed_tensor(seed ^ RP_SEED_SALT),
                          shape=tuple(x.shape), dtype=x.dtype, cfg=cfg)
    return y, ct


def decompress_matmul(ct: CompressedTensor, g2d: torch.Tensor,
                      fused: str = "auto") -> torch.Tensor:
    """Backward matmul ``dw = x_hat^T @ g`` for the (M, D) input ``ct``
    stashes and its (M, N) output gradient ``g2d``: fused (dequantize in
    the product's prologue, no f32 reconstruction in memory) or, when
    :func:`repro_torch.core.backend.route_fused` declines, two-pass."""
    cfg = ct.cfg
    levels = cfg.levels()
    concrete = backend.route_fused(fused, cfg.impl, ct.shape, cfg.bits,
                                   cfg.group_size, levels, cfg.rp_ratio,
                                   g2d.device)
    d = ct.shape[-1]
    if concrete is None:
        x_hat = decompress(ct)
        return (x_hat.reshape(-1, d).to(torch.float32).T
                @ g2d.to(torch.float32))
    return backend.dequant_matmul(ct.packed, ct.zero, ct.rng,
                                  g2d.to(torch.float32), cfg.bits,
                                  cfg.group_size, d, levels, impl=concrete)
