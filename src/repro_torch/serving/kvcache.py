"""Block-wise-quantized paged KV cache for the continuous-batching engine
(the reference's ``repro.serving.kvcache``).

The decode KV cache is carved into fixed-size **pages** of ``page_tokens``
tokens; each slot's logical sequence maps to physical pages through a
per-slot page table (``layout.null_page``, one past the pool end, marks
unallocated entries).  Every token's (Hkv*Dh)-element K and V rows are
quantized per ``group_size`` block through the paper's quantize/pack path
as they are written, each token with its own seed
(:func:`repro_torch.engine.seeds.kv_seed`), in one seeded ``quant_pack``
launch per layer and stream.  The pool holds packed codes (int32 bit views
of the reference's uint32 words) plus per-block (zero, range) float32
stats.  ``bits=16`` stores raw bf16 pages instead.

Page layout per (layer, physical page), one of the two K/V streams::

    quantized:  packed (page_tokens, blocks_per_token, words_per_block)
                zero/rng (page_tokens, blocks_per_token) f32
    raw bf16:   (page_tokens, n_kv_heads, d_head)

The reference's out-of-bounds scatters (``mode="drop"``) and gathers
(``mode="fill"``) at ``null_page`` are spelled out with masks: a torch
index past the end raises on the CPU and faults on the card, and the pool
has no sink page (its bytes are exactly ``layout.pool_bytes``).  Writes
update the pool tensors in place.

Placement (``KVCacheConfig.policy``, :func:`place_kv_pool`): ``"device"``
keeps the pool on the card; ``"host"`` and ``"pinned-paged"`` keep it in
pageable or page-locked host memory (:class:`HostKVPool`) and serve it one
layer at a time through a device stage, the next layer copied in on a side
stream (:mod:`repro_torch.offload.engine`) while the current one computes,
and only the rows a step wrote copied back.  Every placement reads and
writes the same bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backend
from repro_torch.core import pack as packmod
from repro_torch.core.device import resolve_device
from repro_torch.engine.seeds import kv_seed
from repro_torch.kernels import ops
from repro_torch.offload.engine import (POLICIES, SideStream, host_empty,
                                        resolve_mechanism)

#: Supported KV cache widths: 2/4/8 quantized, 16 = raw bf16 pages.
KV_BITS = (2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """User-facing knobs for the paged KV cache."""
    bits: int = 8
    group_size: int = 64
    policy: str = "device"
    page_tokens: int = 16
    n_pages: int = 64


@dataclasses.dataclass(frozen=True)
class KVPageLayout:
    """Resolved page-pool geometry (validated by :func:`plan_kv_layout`)."""
    n_layers: int
    n_kv_heads: int
    d_head: int
    bits: int
    group_size: int      # effective per-token quant group
    page_tokens: int
    n_pages: int
    policy: str = "device"

    # ------------------------------------------------------------ geometry
    @property
    def quantized(self) -> bool:
        return self.bits < 16

    @property
    def elems_per_token(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def blocks_per_token(self) -> int:
        return self.elems_per_token // self.group_size

    @property
    def words_per_block(self) -> int:
        return packmod.packed_len(self.group_size, self.bits) \
            if self.quantized else 0

    @property
    def words_per_page(self) -> int:
        """32-bit words of one page's packed-code (or raw bf16) stream."""
        if self.quantized:
            return self.page_tokens * self.blocks_per_token \
                * self.words_per_block
        return self.page_tokens * self.elems_per_token * 2 // 4

    @property
    def null_page(self) -> int:
        """Sentinel page id for unallocated table entries: one past the
        pool end (writes there are dropped, reads fill zeros)."""
        return self.n_pages

    # --------------------------------------------------------------- bytes
    @property
    def page_bytes(self) -> int:
        """Stored bytes of one page, both K and V streams."""
        per = self.words_per_page * 4
        if self.quantized:
            per += self.page_tokens * self.blocks_per_token * 8  # zero+rng
        return 2 * per

    @property
    def pool_bytes(self) -> int:
        return self.n_layers * self.n_pages * self.page_bytes

    @property
    def f32_page_bytes(self) -> int:
        """The same page capacity stored as uncompressed f32 K+V."""
        return 2 * self.page_tokens * self.elems_per_token * 4

    @property
    def f32_pool_bytes(self) -> int:
        return self.n_layers * self.n_pages * self.f32_page_bytes

    @property
    def total_words(self) -> int:
        return self.n_layers * self.n_pages * self.words_per_page

    def page_segments(self):
        """Flat-word-space segments of every (layer, page) in one packed
        stream: (layer, page, offset, length)."""
        for li in range(self.n_layers):
            for p in range(self.n_pages):
                off = (li * self.n_pages + p) * self.words_per_page
                yield li, p, off, self.words_per_page


def plan_kv_layout(kv: KVCacheConfig, *, n_layers: int, n_kv_heads: int,
                   d_head: int) -> KVPageLayout:
    """Validate a :class:`KVCacheConfig` against the model's KV row and
    resolve the page geometry."""
    if kv.policy not in POLICIES:
        raise ValueError(f"offload={kv.policy!r} not in {POLICIES}")
    if kv.bits not in KV_BITS:
        raise ValueError(f"kv bits={kv.bits} not in {KV_BITS}")
    if kv.page_tokens < 1:
        raise ValueError(f"page_tokens={kv.page_tokens} must be >= 1")
    if kv.n_pages < 1:
        raise ValueError(f"n_pages={kv.n_pages} must be >= 1")
    elems = n_kv_heads * d_head
    g = min(kv.group_size, elems)
    if g < 1 or elems % g:
        raise ValueError(
            f"group_size={kv.group_size} (effective {g}) must divide the "
            f"{elems}-element KV token row (Hkv={n_kv_heads} x Dh={d_head}) "
            "so quant blocks never straddle tokens")
    # whole words a block, as the reference's kernel rule asks (the quant
    # kernels would also take ragged words; the page layout keeps to this)
    reason = None if kv.bits == 16 else packmod.ragged_words(g, kv.bits)
    if reason is not None:
        raise ValueError(f"kv cache quantization infeasible: {reason}")
    return KVPageLayout(n_layers=n_layers, n_kv_heads=n_kv_heads,
                        d_head=d_head, bits=kv.bits, group_size=g,
                        page_tokens=kv.page_tokens, n_pages=kv.n_pages,
                        policy=kv.policy)


# ================================================================= pools
def init_kv_pool(layout: KVPageLayout, device="cuda") -> dict:
    """Zero-initialized page pool on ``device`` (the card unless the CPU is
    asked for; raises without one); every tensor carries a leading layer
    axis.  Its bytes are exactly ``layout.pool_bytes``."""
    device = resolve_device(device)
    L, P, T = layout.n_layers, layout.n_pages, layout.page_tokens
    if not layout.quantized:
        kv_shape = (L, P, T, layout.n_kv_heads, layout.d_head)
        return {name: torch.zeros(kv_shape, dtype=torch.bfloat16,
                                  device=device) for name in ("k", "v")}
    nbt, wpb = layout.blocks_per_token, layout.words_per_block
    pool = {}
    for name in ("k", "v"):
        pool[f"{name}_packed"] = torch.zeros((L, P, T, nbt, wpb),
                                             dtype=torch.int32, device=device)
        pool[f"{name}_zero"] = torch.zeros((L, P, T, nbt), device=device)
        pool[f"{name}_rng"] = torch.zeros((L, P, T, nbt), device=device)
    return pool


class HostKVPool:
    """The page pool in host memory (pageable for ``policy="host"``,
    page-locked for ``"pinned-paged"``, where failing to pin raises),
    served through two layer-sized stages on the card.

    ``layer(li)`` makes the compute stream wait for layer li's pages in its
    stage and starts copying layer li + 1's into the other stage on the
    side stream, so that copy runs under layer li's compute.  The quant
    kernels write into the stage; ``commit_rows`` and ``commit_pages`` copy
    back only what was written (one token row a slot at decode, the
    prompt's pages at prefill).  The host pool thus always holds what the
    ``device`` policy's pool holds, and every read sees the same bits."""

    def __init__(self, pool: dict, layout: KVPageLayout):
        self.layout = layout
        self.device = next(iter(pool.values())).device
        pinned = (resolve_mechanism(layout.policy) == "pinned"
                  and self.device.type == "cuda")
        self.host = {}
        for name, t in pool.items():
            self.host[name] = host_empty(t.shape, t.dtype, pinned)
            self.host[name].copy_(t)
        self.stages = [{name: torch.empty_like(t[0])
                        for name, t in pool.items()} for _ in range(2)]
        self.side = SideStream(self.device)
        self._ready: dict[int, object] = {}

    def _fetch(self, li: int):
        # after the compute stream's last reads of this stage (layer li - 2)
        self.side.follow_compute()
        for name, h in self.host.items():
            self.side.copy(self.stages[li % 2][name], h[li])
        return self.side.record()

    def layer(self, li: int, read: bool = True) -> dict:
        stage = self.stages[li % 2]
        if not read:
            # a write-only pass (prefill): the stage's contents do not
            # matter, but its copies back (and any fetch) must be done
            self._ready.clear()
            self.side.hand_over(self.side.record())
            return stage
        ev = self._ready.pop(li, None)
        self.side.hand_over(ev if ev is not None else self._fetch(li))
        if li + 1 < self.layout.n_layers:
            self._ready[li + 1] = self._fetch(li + 1)
        return stage

    def commit_rows(self, li: int, rows) -> None:
        """Copy the token rows ``rows`` ((page, offset) pairs) of layer
        li's stage back to the host pool."""
        self.side.follow_compute()
        stage = self.stages[li % 2]
        for name, h in self.host.items():
            for page, off in rows:
                self.side.copy(h[li, page, off], stage[name][page, off])

    def commit_pages(self, li: int, pages) -> None:
        """Copy pages ``pages`` of layer li's stage back to the host pool,
        one copy a run of consecutive page ids."""
        self.side.follow_compute()
        stage = self.stages[li % 2]
        ids = sorted({int(p) for p in pages})
        runs, start = [], 0
        for i in range(1, len(ids) + 1):
            if i == len(ids) or ids[i] != ids[i - 1] + 1:
                runs.append((ids[start], ids[i - 1] + 1))
                start = i
        for name, h in self.host.items():
            for a, b in runs:
                self.side.copy(h[li, a:b], stage[name][a:b])


def pool_nbytes(pool) -> int:
    tensors = pool.host if isinstance(pool, HostKVPool) else pool
    return sum(t.numel() * t.element_size() for t in tensors.values())


def place_kv_pool(pool: dict, layout: KVPageLayout):
    """The pool where the layout's policy puts it, and the mechanism used:
    ``(pool, "device")``, or a :class:`HostKVPool` over a host copy of it
    and ``"pageable"`` / ``"pinned"``."""
    mechanism = resolve_mechanism(layout.policy)
    if mechanism == "device":
        return pool, mechanism
    return HostKVPool(pool, layout), mechanism


def layer_view(pool, li: int, *, read: bool = True) -> dict:
    """Layer ``li`` of every pool tensor, as views that writes land in:
    the pool's own, or a :class:`HostKVPool`'s device stage (``read=False``
    for a caller that only writes: the stage is not filled)."""
    if isinstance(pool, HostKVPool):
        return pool.layer(li, read)
    return {name: t[li] for name, t in pool.items()}


def commit_rows(pool, li: int, rows) -> None:
    """After a decode step's writes to layer li: the written ``(page,
    offset)`` rows go back to a host pool (nothing to do on the device)."""
    if isinstance(pool, HostKVPool) and len(rows):
        pool.commit_rows(li, rows)


def commit_pages(pool, li: int, pages) -> None:
    """After a prefill's writes to layer li: the written pages go back to
    a host pool (nothing to do on the device)."""
    if isinstance(pool, HostKVPool) and len(pages):
        pool.commit_pages(li, pages)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ================================================================ writes
def _quantize_rows(layout: KVPageLayout, t: torch.Tensor,
                   seeds: torch.Tensor):
    """(n, Hkv, Dh) rows -> packed (n, nbt, wpb), zero/rng (n, nbt): every
    row's blocks with that row's seed, counters from 0 (one launch)."""
    n, nbt, g = t.shape[0], layout.blocks_per_token, layout.group_size
    packed, zero, rng = ops.quantize_packed(
        t.to(torch.float32).reshape(n * nbt, g), layout.bits, seeds,
        rows_per_seed=nbt)
    return (packed.reshape(n, nbt, layout.words_per_block),
            zero.reshape(n, nbt), rng.reshape(n, nbt))


def write_token(pool_l: dict, layout: KVPageLayout, page_table, pos, active,
                k_tok, v_tok, seed_k, seed_v, *, rows=None) -> dict:
    """Write one decode token's K/V rows into their page (one layer).

    k_tok/v_tok (B, Hkv, Dh); pos (B,) absolute positions; page_table
    (B, max_pages) physical ids; seed_k/seed_v (B,) per-slot seeds from
    :func:`repro_torch.engine.seeds.kv_seed`.  ``active`` (B,) bool says
    which slots write; it is read on the host (the engine passes its
    scheduler mirror, so nothing waits on the card), and the other slots'
    writes are dropped as the reference's out-of-bounds scatter drops them.
    An active slot must own the page its position falls in.  ``rows``, the
    active slots' indices on the device, may be passed instead of being
    copied there again (the engine copies them once a step).
    """
    if rows is None:
        rows = torch.as_tensor(np.flatnonzero(_host(active)),
                               device=pos.device)
    if not rows.numel():
        return pool_l
    T = layout.page_tokens
    p = pos[rows].to(torch.int64)
    phys = page_table[rows, p // T].to(torch.int64)
    off = p % T
    if not layout.quantized:
        for name, t in (("k", k_tok), ("v", v_tok)):
            pool_l[name][phys, off] = t[rows].to(pool_l[name].dtype)
        return pool_l
    for name, t, seed in (("k", k_tok, seed_k), ("v", v_tok, seed_v)):
        vals = _quantize_rows(layout, t[rows], seed[rows])
        for suffix, val in zip(("packed", "zero", "rng"), vals):
            pool_l[f"{name}_{suffix}"][phys, off] = val
    return pool_l


def write_prompt(pool: dict, layout: KVPageLayout, k, v, phys_pages,
                 slots) -> dict:
    """Scatter a prefill's KV rows into freshly allocated pages.

    k/v (L, B, S, Hkv, Dh) from ``Model.prefill`` with ``max_seq`` padded
    to a page multiple (S % page_tokens == 0); phys_pages (B, S//T)
    physical page ids per slot, on the host (entries at ``null_page`` are
    dropped); slots (B,) slot indices (the seed stream).  Token (b, s) of
    layer li quantizes with ``kv_seed(s, slots[b], li, field)``; one seeded
    ``quant_pack`` launch per layer and stream.
    """
    L, B, S = k.shape[0], k.shape[1], k.shape[2]
    T = layout.page_tokens
    assert S % T == 0, (S, T)
    npg = S // T
    dev = k.device
    phys = _host(phys_pages).astype(np.int64).reshape(B, npg)
    keep_b, keep_p = np.nonzero(phys < layout.n_pages)
    dst = torch.as_tensor(phys[keep_b, keep_p], device=dev)
    keep_b = torch.as_tensor(keep_b, device=dev)
    keep_p = torch.as_tensor(keep_p, device=dev)
    positions = torch.arange(S, device=dev)
    slots = torch.as_tensor(_host(slots).astype(np.int64), device=dev)
    hkv, dh = layout.n_kv_heads, layout.d_head
    for li in range(L):
        pool_l = layer_view(pool, li, read=False)
        for field, (name, t) in enumerate((("k", k[li]), ("v", v[li]))):
            if not layout.quantized:
                paged = t.to(torch.bfloat16).reshape(B, npg, T, hkv, dh)
                pool_l[name][dst] = paged[keep_b, keep_p]
                continue
            seeds = kv_seed(positions[None, :], slots[:, None], li, field)
            vals = _quantize_rows(layout, t.reshape(B * S, hkv, dh),
                                  seeds.reshape(-1))
            for suffix, val in zip(("packed", "zero", "rng"), vals):
                paged = val.reshape(B, npg, T, *val.shape[1:])
                pool_l[f"{name}_{suffix}"][dst] = paged[keep_b, keep_p]
        commit_pages(pool, li, phys[phys < layout.n_pages])
    return pool


# ================================================================= reads
def _gather_pages(t: torch.Tensor, table: torch.Tensor, n_pages: int):
    """``t[table]`` over the page axis, zeros where ``table`` holds the
    null page (the reference's ``mode="fill"`` gather)."""
    valid = table < n_pages
    pages = t[table.clamp(max=n_pages - 1).to(torch.int64)]
    mask = valid.reshape(*valid.shape, *([1] * (pages.dim() - valid.dim())))
    return torch.where(mask, pages, torch.zeros((), dtype=t.dtype,
                                                device=t.device))


def gather_kv_raw(pool_l: dict, layout: KVPageLayout, page_table):
    """bits=16 read path: a slot's pages as the dense (B, max_pages*T, Hkv,
    Dh) float32 window (unallocated pages read as zeros)."""
    B, maxp = page_table.shape
    return tuple(
        _gather_pages(pool_l[name], page_table, layout.n_pages).reshape(
            B, maxp * layout.page_tokens, layout.n_kv_heads, layout.d_head
        ).to(torch.float32) for name in ("k", "v"))


def make_page_fetch(pool_l: dict, layout: KVPageLayout, page_table):
    """Quantized read path: a ``fetch(j)`` closure for
    :func:`repro_torch.models.attention.decode_attend_paged` that
    dequantizes exactly page ``j`` of every slot, K and V together in one
    ``dequant_unpack`` launch (through
    :func:`repro_torch.core.backend.dequantize_blocks`: the kernel on the
    card, the plain version on the CPU).  ``fetch(j)`` returns kf, vf
    (B, T, Hkv, Dh) float32 and kv_pos (T,), the page's absolute positions.

    The pages' codes (the packed words and each block's ``zero`` and
    ``range``, about an eighth of the float32 K/V at 4 bits) are gathered
    once, page-major with K before V, so page ``j`` is one contiguous slice
    and a fetch launches nothing but its dequantization; the float32 K/V
    of no more than one page exists at a time, as in the reference's read.
    A null page reads as zeros, as the reference's ``mode="fill"`` gather
    does: its ``zero`` and ``range`` are zeroed, so every code dequantizes
    to 0 (the codes themselves are read from a clamped page id)."""
    B, maxp = page_table.shape
    P, T = layout.n_pages, layout.page_tokens
    n = B * T * layout.blocks_per_token          # blocks of a page, a stream
    idx = page_table.T.clamp(max=P - 1).reshape(-1).to(torch.int64)
    valid = (page_table.T < P).repeat(1, 2)[:, :, None]   # (maxp, 2B, 1)

    def gather(field):
        return torch.cat([pool_l[f"{name}_{field}"].index_select(0, idx)
                          .view(maxp, n, -1) for name in ("k", "v")], 1)

    packed = gather("packed")                           # (maxp, 2n, wpb)
    zero, rng = (torch.where(valid, gather(f).view(maxp, 2 * B, -1), 0.0)
                 .view(maxp, 2 * n) for f in ("zero", "rng"))
    kv_pos = torch.arange(maxp * T, device=page_table.device).view(maxp, T)

    def fetch(j: int):
        kv = backend.dequantize_blocks(packed[j], zero[j], rng[j],
                                       layout.bits, layout.group_size)
        kv = kv.view(2, B, T, layout.n_kv_heads, layout.d_head)
        return kv[0], kv[1], kv_pos[j]

    return fetch


# ============================================================= allocator
class PageAllocator:
    """Host-side free-list allocator over the physical page pool.

    Deterministic: pages hand out in ascending id order and freed pages
    return to the tail, so identical admission traces replay to identical
    page tables.  Bounds and double-free are hard errors."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages={n_pages} must be >= 1")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._used: set[int] = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> list[int] | None:
        """n physical pages, or None when the pool cannot satisfy them
        (the scheduler's signal to hold admission)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(
                    f"page id {p} outside the [0, {self.n_pages}) pool")
            if p not in self._used:
                raise ValueError(f"double free of page {p}")
            self._used.remove(p)
            self._free.append(p)
