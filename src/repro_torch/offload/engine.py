"""Offload engine: where the stash bytes live between a layer's forward and
its backward (the reference's ``repro.offload.engine``).

Policies and the memory each maps to (:func:`resolve_mechanism`):

* ``"device"``       -> ``"device"``: one pooled arena pair on the card; the
                        backward reads views of it.
* ``"host"``         -> ``"pageable"``: every layer's segments go to a host
                        arena in pageable CPU memory right after the layer's
                        stash kernels; the backward walk brings them back one
                        layer ahead, so at most two layers' segments are on
                        the card at once.
* ``"pinned-paged"`` -> ``"pinned"``: as ``"host"``, in page-locked memory,
                        the packed codes copied in :data:`PAGE_WORDS`-word
                        pages.  Pinning that fails raises; it never falls back
                        to pageable memory.

The per-tensor stash (``StashPolicy(kind="tensor")``) is a fourth writer and
reader pair, ``"tensor"``: the per-layer dict of tensors the engine always
kept, with no copy and no launch added.

Copies to and from the host run on a side ``torch.cuda.Stream``
(:class:`SideStream`).  A copy out waits for everything the compute stream
has queued (the layer's stash kernels included), and the tensors it reads
are marked used by the side stream (``record_stream``), so their memory is
not reused before it is done.  A copy back into a freshly allocated device
buffer also waits for the compute stream (the buffer's memory may have
served kernels queued there), and the compute stream waits on the copy's
event before it reads the buffer.  Host arenas are allocated once per
:class:`ArenaStore` and reused; a reused one is first waited on (its last
copies out of it may still run).  On the CPU (the tests ask for it) the same
writers and readers run with plain copies into separate CPU tensors.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.core.compressor import CompressedTensor, _seed_tensor
from repro_torch.core.device import resolve_device
from repro_torch.offload import arena as ar

POLICIES = ("device", "host", "pinned-paged")

#: Page size (uint32 words) of the "pinned-paged" packed-code copies.
PAGE_WORDS = 1 << 15

_MECHANISMS = {"device": "device", "host": "pageable",
               "pinned-paged": "pinned"}


def check_policy(policy: str | None) -> str | None:
    if policy is not None and policy not in POLICIES:
        raise ValueError(f"offload={policy!r} not in {POLICIES}")
    return policy


def resolve_mechanism(policy: str) -> str:
    """The memory a policy keeps the stash in: "device", "pageable" (host)
    or "pinned" (page-locked host)."""
    if check_policy(policy) is None:
        raise ValueError("offload=None has no arena mechanism")
    return _MECHANISMS[policy]


# ----------------------------------------------------- measurement helpers
def measure_live_bytes() -> int:
    """Bytes of tensors allocated on the card (0 while this process has not
    used it)."""
    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated())


def device_memory_stats() -> dict | None:
    """The card's allocator counters under the reference's key names
    (``peak_bytes_in_use`` is ``torch.cuda.max_memory_allocated``), or None
    while this process has not used the card."""
    if not torch.cuda.is_initialized():
        return None
    return {"bytes_in_use": int(torch.cuda.memory_allocated()),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated()),
            "bytes_reserved": int(torch.cuda.memory_reserved()),
            "peak_bytes_reserved": int(torch.cuda.max_memory_reserved())}


def device_resident_stash_bytes(plan: ar.StashPlan, policy: str) -> int:
    """Ledger model of the stash bytes on the card during the backward.

    device: the whole pooled arena.  host / pinned-paged: the prefetch
    window, the two largest consecutive layers (at most two layers are on
    the card at once)."""
    if resolve_mechanism(policy) == "device":
        return plan.total_bytes
    sizes = [lp.nbytes for lp in plan.layers]
    if len(sizes) < 2:
        return sum(sizes)
    return max(a + b for a, b in zip(sizes[:-1], sizes[1:]))


# ------------------------------------------------------------ host memory
#: Every host arena alive in this process, for :func:`host_store_bytes`.
_LIVE_HOST: "weakref.WeakSet[HostArenas]" = weakref.WeakSet()


def host_store_bytes() -> int:
    """Stash bytes held in host memory now: written by a forward and not
    yet read back by its backward."""
    return sum(h.held for h in _LIVE_HOST)


def host_empty(shape, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
    """A zeroed CPU tensor, page-locked when ``pinned`` (raises if pinning
    fails: no pageable fallback)."""
    t = torch.zeros(shape, dtype=dtype, pin_memory=pinned)
    if pinned and not t.is_pinned():
        raise RuntimeError(f"could not pin a {tuple(shape)} host buffer")
    return t


class SideStream:
    """Copies on a side CUDA stream, ordered against the compute stream by
    events; on the CPU, plain copies in program order."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def follow_compute(self) -> None:
        """Copies queued from now on start after the compute stream's work
        queued so far."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(
                self.stream.device))

    def copy(self, dst: torch.Tensor, src: torch.Tensor,
             page: int | None = None) -> None:
        """``dst.copy_(src)`` on the side stream, in ``page``-element
        pieces when given.  ``src`` on the card is marked used by the side
        stream."""
        pieces = ([(dst, src)] if page is None else
                  [(dst[i:i + page], src[i:i + page])
                   for i in range(0, src.numel(), page)])
        if self.stream is None:
            for d, s in pieces:
                d.copy_(s)
            return
        with torch.cuda.stream(self.stream):
            for d, s in pieces:
                d.copy_(s, non_blocking=True)
        if src.is_cuda:
            src.record_stream(self.stream)

    def record(self):
        """An event after the copies queued so far (None on the CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    @staticmethod
    def hand_over(ev) -> None:
        """The compute stream waits for ``ev`` (an event from
        :meth:`record`)."""
        if ev is not None:
            torch.cuda.current_stream().wait_event(ev)


class HostArenas:
    """The host copy of one plan's arenas, at their allocated sizes.
    ``held`` counts the segment bytes written and not yet read back;
    ``released`` is the side-stream event after the last copy out of it."""

    def __init__(self, plan: ar.StashPlan, pinned: bool):
        self.arenas = (host_empty((plan.u32_alloc_words,), torch.int32,
                                  pinned),
                       host_empty((plan.f32_alloc_elems,), torch.float32,
                                  pinned))
        self.held = 0
        self.released = None
        _LIVE_HOST.add(self)


class ArenaStore:
    """What a compiled step keeps across its forwards for one
    :class:`~repro_torch.offload.arena.StashPlan` at one policy: the side
    stream and the host arenas of the host policies (allocated once, reused
    by every forward), and the readers' gauges:

    * ``resident_peak``: the most stash bytes a reader held on the card
      during a backward (the device arena's segments, or the prefetched
      layers' buffers);
    * ``packed_views`` / ``misaligned_views``: packed-code views handed to
      the kernels, and how many of them did not start on a 16-byte
      boundary."""

    def __init__(self, plan: ar.StashPlan, policy: str, device="cuda"):
        self.plan, self.policy = plan, policy
        self.mechanism = resolve_mechanism(policy)
        self.device = resolve_device(device)
        self.side = (None if self.mechanism == "device"
                     else SideStream(self.device))
        self._free: list[HostArenas] = []
        self.resident_peak = 0
        self.packed_views = 0
        self.misaligned_views = 0

    def take_host(self) -> HostArenas:
        if not self._free:
            return HostArenas(self.plan, self.mechanism == "pinned"
                              and self.device.type == "cuda")
        h = self._free.pop()
        if h.released is not None:
            h.released.synchronize()   # its last copies out have run
        return h

    def give_host(self, h: HostArenas) -> None:
        h.released = self.side.record()
        self._free.append(h)

    def note_resident(self, nbytes: int) -> None:
        self.resident_peak = max(self.resident_peak, nbytes)

    def note_packed(self, packed: torch.Tensor) -> None:
        self.packed_views += 1
        self.misaligned_views += packed.data_ptr() % 16 != 0

    def stats(self) -> dict:
        p = self.plan
        return {"policy": self.policy, "mechanism": self.mechanism,
                "planned_bytes": p.total_bytes,
                "padding_bytes": p.padding_bytes,
                "per_layer_bytes": [lp.nbytes for lp in p.layers],
                "device_resident_bytes":
                    device_resident_stash_bytes(p, self.policy),
                "resident_peak_bytes": self.resident_peak,
                "packed_views": self.packed_views,
                "misaligned_views": self.misaligned_views}


# ----------------------------------------------- per-tensor residual offload
class HostStash:
    """A ``CompressedTensor`` whose packed words, ``zero`` and ``range`` wait
    in host memory between a forward and its backward (the reference's
    ``HostStash`` ticket).  ``"host"`` keeps them in pageable memory,
    ``"pinned-paged"`` in page-locked memory, the words copied in
    :data:`PAGE_WORDS`-word pages.  The copies out run on the stash's own
    side stream after the compute stream's work queued so far (the stash
    kernels among it); :func:`fetch_compressed` copies back on that stream
    and makes the compute stream wait on its event before anything reads
    the words.  On the CPU the copies are plain copies into new tensors."""

    def __init__(self, ct: CompressedTensor, policy: str):
        mechanism = resolve_mechanism(policy)
        if mechanism == "device":
            raise ValueError("offload='device' keeps the stash where it is")
        self.shape, self.dtype, self.cfg = ct.shape, ct.dtype, ct.cfg
        self.rp_seed = ct.rp_seed          # a host scalar already
        self.device = ct.packed.device
        self.side = SideStream(self.device)
        pinned = mechanism == "pinned" and self.device.type == "cuda"
        self._page = PAGE_WORDS if mechanism == "pinned" else None
        self.side.follow_compute()
        self.host = {}
        for name in ("packed", "zero", "rng"):
            t = getattr(ct, name)
            self.host[name] = host_empty(t.shape, t.dtype, pinned)
            self.side.copy(self.host[name].view(-1), t.reshape(-1),
                           self._page if name == "packed" else None)


def offload_compressed(ct: CompressedTensor, policy: str) -> HostStash:
    """Move one ``CompressedTensor``'s words and block scalars to host
    memory under ``policy`` ("host" | "pinned-paged")."""
    return HostStash(ct, policy)


def fetch_compressed(hs: HostStash) -> CompressedTensor:
    """The stash back on its device, the compute stream waiting for the
    copies before it reads it."""
    bufs = {name: torch.empty(t.shape, dtype=t.dtype, device=hs.device)
            for name, t in hs.host.items()}
    hs.side.follow_compute()
    for name, buf in bufs.items():
        hs.side.copy(buf.view(-1), hs.host[name].view(-1),
                     hs._page if name == "packed" else None)
    hs.side.hand_over(hs.side.record())
    return CompressedTensor(bufs["packed"], bufs["zero"], bufs["rng"],
                            hs.rp_seed, shape=hs.shape, dtype=hs.dtype,
                            cfg=hs.cfg)


# ------------------------------------------------------- per-tensor stash
class _TensorWriter:
    """Stash kind "tensor": no pool, no copy; the residual is the list of
    per-layer dicts of ``CompressedTensor`` / raw f32 / packed ReLU-mask
    tensors the engine's forward always saved."""

    def __init__(self, n_layers: int):
        self._segs = [dict() for _ in range(n_layers)]

    def put_ct(self, li, ct):
        self._segs[li]["ct"] = ct

    def put_raw(self, li, x):
        self._segs[li]["raw"] = x

    def put_mask(self, li, words):
        self._segs[li]["mask"] = words

    def residual(self):
        return self._segs

    def nbytes(self) -> list[int]:
        """Each layer's bytes, counted from the tensors it holds."""
        out = []
        for entry in self._segs:
            n = entry["ct"].nbytes if "ct" in entry else 0
            for key in ("raw", "mask"):
                if key in entry:
                    n += entry[key].numel() * entry[key].element_size()
            out.append(n)
        return out


class _TensorReader:
    def __init__(self, res):
        self._segs = res

    def prefetch(self, li):
        pass  # the residual's tensors are on the card already

    def _pop(self, li, field):
        # a consumed layer leaves the residual: its memory goes as soon as
        # the backward is done with it
        entry = self._segs[li]
        val = entry.pop(field)
        if not entry:
            self._segs[li] = None
        return val

    def get_ct(self, li):
        return self._pop(li, "ct")

    def get_raw(self, li):
        return self._pop(li, "raw")

    def get_mask(self, li):
        return self._pop(li, "mask")


# ------------------------------------------------------------ arena stash
class _ArenaResidual:
    """What an arena forward leaves for its backward: the store, the host
    copies of the RP seeds, and the device arenas or the host arenas."""

    def __init__(self, store: ArenaStore, seeds: list, arenas=None,
                 host: HostArenas | None = None):
        self.store, self.seeds, self.arenas, self.host = (store, seeds,
                                                          arenas, host)


class _DeviceWriter:
    """Policy "device": every segment copied into one arena pair on the
    stash's device, allocated for this forward."""

    def __init__(self, store: ArenaStore):
        self.store, self.plan = store, store.plan
        self.arenas = ar.arena_init(self.plan, store.device)
        self.seeds = [None] * len(self.plan.layers)

    def put_ct(self, li, ct: CompressedTensor):
        ar.stash_write(self.arenas, self.plan, li, ct)
        self.seeds[li] = ct.seed

    def put_raw(self, li, x):
        ar.write_raw(self.arenas, self.plan, li, x)

    def put_mask(self, li, words):
        ar.write_mask(self.arenas, self.plan, li, words)

    def residual(self):
        return _ArenaResidual(self.store, self.seeds, arenas=self.arenas)

    def nbytes(self) -> list[int]:
        return [lp.nbytes for lp in self.plan.layers]


class _DeviceReader:
    def __init__(self, res: _ArenaResidual):
        self.store, self.plan = res.store, res.store.plan
        self.arenas, self.seeds = res.arenas, res.seeds
        self._left = self.plan.n_reads
        self.store.note_resident(self.plan.total_bytes)

    def prefetch(self, li):
        pass  # the segments are views of the device arena

    def _read(self, fn, li, *args):
        val = fn(self.arenas, self.plan, li, *args)
        self._left -= 1
        if not self._left:
            self.arenas = None  # the pool goes with its last view
        return val

    def get_ct(self, li):
        ct = self._read(ar.stash_read, li, self.seeds[li])
        self.store.note_packed(ct.packed)
        return ct

    def get_raw(self, li):
        return self._read(ar.read_raw, li)

    def get_mask(self, li):
        return self._read(ar.read_mask, li)


#: The fields a layer's stash brings back to the card, in copy order (the
#: RP seed stays on the host).
_FIELDS = ("packed", "zero", "rng", "raw", "mask")


class _HostWriter:
    """Policies "host" and "pinned-paged": each segment copied on the side
    stream into the store's host arenas as soon as the layer has stashed
    it; the seed word is written on the host."""

    def __init__(self, store: ArenaStore):
        self.store, self.plan = store, store.plan
        self.host = store.take_host()
        self.seeds = [None] * len(self.plan.layers)
        self._page = PAGE_WORDS if store.policy == "pinned-paged" else None

    def _out(self, seg: ar.Segment, t: torch.Tensor) -> None:
        self.store.side.copy(ar.segment_view(self.host.arenas, seg),
                             t.reshape(-1),
                             self._page if seg.arena == "u32" else None)
        self.host.held += seg.nbytes

    def put_ct(self, li, ct: CompressedTensor):
        lp = self.plan.layers[li]
        self.store.side.follow_compute()
        self._out(lp.packed, ct.packed)
        self._out(lp.zero, ct.zero)
        self._out(lp.rng, ct.rng)
        ar.segment_view(self.host.arenas, lp.rp_seed).copy_(ct.rp_seed)
        self.host.held += lp.rp_seed.nbytes
        self.seeds[li] = ct.seed

    def put_raw(self, li, x):
        self.store.side.follow_compute()
        self._out(self.plan.layers[li].raw, x)

    def put_mask(self, li, words):
        self.store.side.follow_compute()
        self._out(self.plan.layers[li].mask, words)

    def residual(self):
        return _ArenaResidual(self.store, self.seeds, host=self.host)

    def nbytes(self) -> list[int]:
        return [lp.nbytes for lp in self.plan.layers]


class _HostReader:
    """Brings a layer's segments back into fresh device buffers on the side
    stream when asked (``prefetch``, one layer ahead of the walk), drops
    each buffer once consumed, and returns the host arenas to the store
    after the last one."""

    def __init__(self, res: _ArenaResidual):
        self.store, self.plan = res.store, res.store.plan
        self.host, self.seeds = res.host, res.seeds
        self._page = PAGE_WORDS if self.store.policy == "pinned-paged" \
            else None
        self._cache: dict[int, tuple] = {}
        self._fetched: set[int] = set()
        self._left = sum(len(self._fields(lp)) for lp in self.plan.layers)
        self._resident = 0

    @staticmethod
    def _fields(lp) -> list[str]:
        return [f for f in _FIELDS if getattr(lp, f) is not None]

    def prefetch(self, li):
        if li < 0 or li in self._fetched:
            return
        self._fetched.add(li)
        lp = self.plan.layers[li]
        bufs = {}
        for f in self._fields(lp):
            seg = getattr(lp, f)
            bufs[f] = torch.empty(
                (seg.size,), device=self.store.device,
                dtype=torch.int32 if seg.arena == "u32" else torch.float32)
        side = self.store.side
        side.follow_compute()
        for f, buf in bufs.items():
            seg = getattr(lp, f)
            side.copy(buf, ar.segment_view(self.host.arenas, seg),
                      self._page if seg.arena == "u32" else None)
        self._cache[li] = (side.record(), bufs)
        self._resident += sum(b.numel() * 4 for b in bufs.values())
        self.store.note_resident(self._resident)

    def _pop(self, li, field) -> torch.Tensor:
        self.prefetch(li)
        ev, bufs = self._cache[li]
        self.store.side.hand_over(ev)
        buf = bufs.pop(field)
        if not bufs:
            del self._cache[li]
        self._resident -= buf.numel() * 4
        self.host.held -= buf.numel() * 4
        self._left -= 1
        if not self._left:
            self.store.give_host(self.host)
            self.host = None
        return buf

    def get_ct(self, li) -> CompressedTensor:
        lp = self.plan.layers[li]
        self.host.held -= lp.rp_seed.nbytes   # the seed's host copy is read
        packed = self._pop(li, "packed").view(lp.n_blocks, lp.words_per_block)
        zero, rng = self._pop(li, "zero"), self._pop(li, "rng")
        self.store.note_packed(packed)
        return CompressedTensor(
            packed=packed, zero=zero, rng=rng,
            rp_seed=_seed_tensor(self.seeds[li]), shape=lp.shape, dtype=getattr(torch, self.plan.dtype),
            cfg=lp.cfg)

    def get_raw(self, li):
        lp = self.plan.layers[li]
        return self._pop(li, "raw").view(lp.shape).to(
            getattr(torch, self.plan.dtype))

    def get_mask(self, li):
        lp = self.plan.layers[li]
        return self._pop(li, "mask").view(1, lp.mask.size)


# ---------------------------------------------------------------- routing
_WRITERS = {"device": _DeviceWriter, "pageable": _HostWriter,
            "pinned": _HostWriter}
_READERS = {"device": _DeviceReader, "pageable": _HostReader,
            "pinned": _HostReader}


def make_writer(store: ArenaStore | None, n_layers: int):
    """The stash writer of one forward: per-tensor when ``store`` is None,
    else the store's policy's arena writer."""
    if store is None:
        return _TensorWriter(n_layers)
    if len(store.plan.layers) != n_layers:
        raise ValueError(f"plan has {len(store.plan.layers)} layers for a "
                         f"{n_layers}-layer model")
    return _WRITERS[store.mechanism](store)


def make_reader(residual):
    """The backward walk's reader over a writer's residual.  Call
    ``prefetch(li - 1)`` before consuming layer ``li`` to keep the copy back
    to the card one layer ahead; every field is read once."""
    if not isinstance(residual, _ArenaResidual):
        return _TensorReader(residual)
    return _READERS[residual.store.mechanism](residual)
