"""Arena planner: the static layout of every layer's stash in pooled
arenas (the reference's ``repro.offload.arena``).

A :class:`StashPlan` is computed once per (model config x live node count)
from static information only: each layer's :class:`CompressionConfig`
(autoprec's mixed widths included), its stash shape and its ReLU-mask
element count.  Every field gets a :class:`Segment` in one ``u32`` arena
(packed code words, RP seeds, ReLU sign masks; an ``int32`` bit view, as
``CompressedTensor.packed`` is) or one ``float32`` arena (per-block zero and
range, and the raw f32 input of an uncompressed layer).

Two offsets per segment.  ``offset`` is the reference's: segments end to
end with no padding, so the plan's bytes and per-layer rows equal the
reference's and the per-tensor stash's.  ``start`` is where the segment
lands in the allocated arena: rounded up to :data:`ALIGN_WORDS` words, so
every view handed to a kernel starts on a 16-byte boundary (the quant and
fused kernels take their vector paths only there).  The words between are
``StashPlan.padding_bytes``, allocated and never read.

``stash_write`` / ``stash_read`` copy bits and nothing else:
``decompress(stash_read(stash_write(ct)))`` is ``decompress(ct)`` bit for
bit.  The plan is hashable (frozen dataclasses of tuples) and doubles as
the byte ledger the memory report reads (:meth:`StashPlan.per_layer_rows`,
:attr:`StashPlan.total_bytes`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import pack as packmod
from repro_torch.core.compressor import (CompressedTensor, CompressionConfig,
                                         _seed_tensor)
from repro_torch.core.device import resolve_device
from repro_torch.core.prng import MASK32

#: Segment starts in the allocated arenas are multiples of this many words
#: (16 bytes).
ALIGN_WORDS = 4


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous span of one arena: ``arena`` in {"u32", "f32"},
    ``offset`` in the reference's unpadded layout, ``start`` in the
    allocated (16-byte aligned) one."""

    arena: str
    offset: int
    size: int
    start: int

    @property
    def nbytes(self) -> int:
        return 4 * self.size  # both arenas hold 4-byte elements


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Static geometry and segments of one layer's stash.

    Compressed layers carry ``packed``/``zero``/``rng``/``rp_seed``
    segments, uncompressed layers a ``raw`` f32 segment; hidden layers also
    a ``mask`` segment for the word-aligned 1-bit ReLU sign mask
    (``mask_elems`` elements before packing)."""

    index: int
    cfg: CompressionConfig | None
    shape: tuple[int, ...]        # pre-RP stash shape
    proj_shape: tuple[int, ...]   # post-RP shape (== shape when no RP)
    n_blocks: int
    words_per_block: int
    packed: Segment | None
    zero: Segment | None
    rng: Segment | None
    rp_seed: Segment | None
    raw: Segment | None
    mask: Segment | None
    mask_elems: int

    def segments(self) -> tuple[Segment, ...]:
        return tuple(s for s in (self.packed, self.zero, self.rng,
                                 self.rp_seed, self.raw, self.mask)
                     if s is not None)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.segments())

    @property
    def n_reads(self) -> int:
        """Backward-pass fetches this layer issues (stash + optional mask)."""
        return 1 + (1 if self.mask is not None else 0)


@dataclasses.dataclass(frozen=True)
class StashPlan:
    layers: tuple[LayerPlan, ...]
    u32_words: int
    f32_elems: int
    u32_alloc_words: int          # allocated, segment starts aligned
    f32_alloc_elems: int
    dtype: str = "float32"        # dtype the stashes decompress back to

    # ------------------------------------------------------------ ledger
    @property
    def u32_bytes(self) -> int:
        return 4 * self.u32_words

    @property
    def f32_bytes(self) -> int:
        return 4 * self.f32_elems

    @property
    def total_bytes(self) -> int:
        return self.u32_bytes + self.f32_bytes

    @property
    def padding_bytes(self) -> int:
        """Alignment words the allocated arenas add to ``total_bytes``."""
        return 4 * (self.u32_alloc_words + self.f32_alloc_elems) \
            - self.total_bytes

    @property
    def max_layer_bytes(self) -> int:
        return max((lp.nbytes for lp in self.layers), default=0)

    @property
    def n_reads(self) -> int:
        return sum(lp.n_reads for lp in self.layers)

    def per_layer_rows(self) -> list[dict]:
        rows = []
        for lp in self.layers:
            row = {"layer": lp.index, "arena_bytes": lp.nbytes,
                   "bits": None if lp.cfg is None else lp.cfg.bits}
            if lp.mask is not None:
                row["mask_bytes"] = lp.mask.nbytes
            rows.append(row)
        return rows


def _stash_geometry(shape: tuple[int, ...], cfg: CompressionConfig):
    """(proj_shape, n_blocks, words_per_block), as ``compress`` lays them
    out: optional RP on the last dim, then flatten and regroup into
    G-blocks."""
    if cfg.rp_ratio > 1:
        d = shape[-1]
        if d % cfg.rp_ratio:
            raise ValueError(f"last dim {d} not divisible by rp_ratio "
                             f"{cfg.rp_ratio}")
        proj_shape = (*shape[:-1], d // cfg.rp_ratio)
    else:
        proj_shape = tuple(shape)
    numel = 1
    for s in proj_shape:
        numel *= s
    n_blocks = (numel + cfg.group_size - 1) // cfg.group_size
    return proj_shape, n_blocks, packmod.packed_len(cfg.group_size, cfg.bits)


class _Cursor:
    """Next free element of one arena, in both layouts."""

    def __init__(self, arena: str):
        self.arena, self.offset, self.start = arena, 0, 0

    def take(self, size: int) -> Segment:
        start = -(-self.start // ALIGN_WORDS) * ALIGN_WORDS
        seg = Segment(self.arena, self.offset, size, start)
        self.offset += size
        self.start = start + size
        return seg


def plan_stashes(shapes: tuple[tuple[int, ...], ...],
                 cfgs: tuple[CompressionConfig | None, ...],
                 mask_elems: tuple[int, ...] | None = None,
                 dtype: str = "float32") -> StashPlan:
    """Lay one stash per layer into the pooled arenas.

    ``shapes[li]`` is the pre-RP shape of what layer li saves, ``cfgs[li]``
    its compression config (``None``: stored raw f32), and
    ``mask_elems[li]`` the element count of its 1-bit ReLU mask (0 = no
    mask).  Offsets are the reference's (sequential, no padding), so the
    arena byte total equals the per-tensor stash's; starts are aligned."""
    if mask_elems is None:
        mask_elems = (0,) * len(shapes)
    if not (len(shapes) == len(cfgs) == len(mask_elems)):
        raise ValueError("shapes/cfgs/mask_elems length mismatch")
    u32, f32 = _Cursor("u32"), _Cursor("f32")
    layers = []
    for li, (shape, cfg, me) in enumerate(zip(shapes, cfgs, mask_elems)):
        packed = zero = rng = rp_seed = raw = mask = None
        if cfg is None:
            numel = 1
            for s in shape:
                numel *= s
            raw = f32.take(numel)
            proj_shape, n_blocks, wpb = tuple(shape), 0, 0
        else:
            proj_shape, n_blocks, wpb = _stash_geometry(shape, cfg)
            packed = u32.take(n_blocks * wpb)
            rp_seed = u32.take(1)
            zero = f32.take(n_blocks)
            rng = f32.take(n_blocks)
        if me:
            mask = u32.take(packmod.packed_len(me, 1))
        layers.append(LayerPlan(
            index=li, cfg=cfg, shape=tuple(shape), proj_shape=proj_shape,
            n_blocks=n_blocks, words_per_block=wpb, packed=packed, zero=zero,
            rng=rng, rp_seed=rp_seed, raw=raw, mask=mask, mask_elems=me))
    return StashPlan(layers=tuple(layers), u32_words=u32.offset,
                     f32_elems=f32.offset, u32_alloc_words=u32.start,
                     f32_alloc_elems=f32.start, dtype=dtype)


# ---------------------------------------------------------------- arenas
def arena_init(plan: StashPlan, device="cuda"):
    """A fresh zeroed (u32, f32) arena pair of the allocated sizes on
    ``device`` (the card unless the CPU is asked for)."""
    device = resolve_device(device)
    return (torch.zeros((plan.u32_alloc_words,), dtype=torch.int32,
                        device=device),
            torch.zeros((plan.f32_alloc_elems,), dtype=torch.float32,
                        device=device))


def segment_view(arenas, seg: Segment) -> torch.Tensor:
    """The 1-D view of ``seg`` in its arena (writes land in the arena)."""
    arena = arenas[0] if seg.arena == "u32" else arenas[1]
    return arena[seg.start:seg.start + seg.size]


def _seg_set(arenas, seg: Segment, values: torch.Tensor) -> None:
    segment_view(arenas, seg).copy_(values.reshape(-1))


def _layer(plan: StashPlan, li: int, field: str) -> LayerPlan:
    lp = plan.layers[li]
    if getattr(lp, field) is None:
        kind = "compressed" if lp.raw is None else "raw"
        raise ValueError(f"layer {li} is planned {kind}; it has no "
                         f"{field} segment")
    return lp


def stash_write(arenas, plan: StashPlan, li: int, ct: CompressedTensor):
    """Copy a ``CompressedTensor``'s fields into layer li's segments.  The
    seed word is written with a fill from the host copy of the seed (no
    host-to-device copy)."""
    lp = _layer(plan, li, "packed")
    _seg_set(arenas, lp.packed, ct.packed)
    # rp_seed is a host tensor: the fill takes its value as an argument
    segment_view(arenas, lp.rp_seed).fill_(int(ct.rp_seed))
    _seg_set(arenas, lp.zero, ct.zero)
    _seg_set(arenas, lp.rng, ct.rng)
    return arenas


def stash_read(arenas, plan: StashPlan, li: int,
               seed: int | None = None) -> CompressedTensor:
    """Rebuild layer li's ``CompressedTensor`` from views of the arenas.
    ``seed`` is the host copy of the RP seed; without it the seed word is
    read from the arena (a device read on the card)."""
    lp = _layer(plan, li, "packed")
    if seed is None:
        seed = int(segment_view(arenas, lp.rp_seed)[0]) & MASK32
    return CompressedTensor(
        packed=segment_view(arenas, lp.packed).view(lp.n_blocks,
                                                    lp.words_per_block),
        zero=segment_view(arenas, lp.zero),
        rng=segment_view(arenas, lp.rng),
        rp_seed=_seed_tensor(seed),
        shape=lp.shape, dtype=getattr(torch, plan.dtype), cfg=lp.cfg)


def write_raw(arenas, plan: StashPlan, li: int, x: torch.Tensor):
    """Store an uncompressed layer's f32 stash in the f32 arena."""
    _seg_set(arenas, _layer(plan, li, "raw").raw, x)
    return arenas


def read_raw(arenas, plan: StashPlan, li: int) -> torch.Tensor:
    lp = _layer(plan, li, "raw")
    return segment_view(arenas, lp.raw).view(lp.shape).to(
        getattr(torch, plan.dtype))


def write_mask(arenas, plan: StashPlan, li: int, mask_words: torch.Tensor):
    """Store a layer's packed 1-bit ReLU sign mask ((1, n_words) int32)."""
    _seg_set(arenas, _layer(plan, li, "mask").mask, mask_words)
    return arenas


def read_mask(arenas, plan: StashPlan, li: int) -> torch.Tensor:
    lp = _layer(plan, li, "mask")
    return segment_view(arenas, lp.mask).view(1, lp.mask.size)
