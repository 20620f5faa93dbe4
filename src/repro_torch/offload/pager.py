"""Host-resident feature pager for mesh-sharded training (the reference's
``repro.offload.pager``).

The mesh engine never keeps the feature matrix on the device: the
:class:`~repro_torch.parallel.halo.HaloProgram`'s ``(rounds, m, n_pad, F)``
features stay in host memory, and each rank's :class:`FeaturePager` holds
its own partitions' rows, cut into pages of
:data:`repro_torch.offload.engine.PAGE_WORDS` f32 words (the granularity of
the stash arena's pinned-paged policy), page-locked on the card:

* ``prefetch(r)`` queues the host-to-device copies of round ``r``'s pages
  on a side CUDA stream (:class:`~repro_torch.offload.engine.SideStream`)
  and records an event, so the copies overlap the current round's compute;
* ``fetch(r)`` makes the compute stream wait for that event and hands
  over the round's ``(n_pad, F)`` block, into whose rows the pages were
  copied (the copies are the concatenation).

Neither blocks the host.  The overlap is measured on the device: the time
the compute stream waited for a round's copies against the copies' own
time, read back (with CUDA events) when :meth:`FeaturePager.stats` is
called; ``overlap_frac`` is the lifetime share of copy time hidden behind
compute.  Each fetch's own overlap lands, once its timings are read, in
the windowed ``pager/overlap_frac`` histogram of the metrics registry
(``metrics=``, the run's :class:`~repro_torch.obs.metrics.MetricsRegistry`;
a private one when none is passed), so ``overlap_frac_window`` is the mean
of the last ``window`` fetches: recent behaviour, where the lifetime share
averages early stalls away.  The registry also counts ``pager/fetches``
and ``pager/prefetch_hits`` and holds the ``pager/round_bytes`` and
``pager/host_bytes`` gauges.  On the CPU the pages are plain tensors
copied in program order, and nothing waits.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.offload.engine import PAGE_WORDS, SideStream, host_empty

#: Default size of the per-fetch overlap window (rounds, not epochs).
OVERLAP_WINDOW = 32


class FeaturePager:
    """Pages one rank's round of partition features to its device at a
    time: rows ``features[r, rank]`` for round ``r``."""

    def __init__(self, features: np.ndarray, device, *, rank: int = 0,
                 page_rows: int | None = None,
                 metrics: MetricsRegistry | None = None,
                 window: int = OVERLAP_WINDOW):
        if features.ndim != 4:
            raise ValueError("features must be (rounds, m, n_pad, F); got "
                             f"shape {features.shape}")
        self.device = torch.device(device)
        self.rounds = int(features.shape[0])
        n_pad, f = int(features.shape[2]), int(features.shape[3])
        self.n_pad, self.n_feats = n_pad, f
        self.page_rows = (int(page_rows) if page_rows
                          else max(1, PAGE_WORDS // max(1, f)))
        pinned = self.device.type == "cuda"
        self.host_kind = "pinned" if pinned else "pageable"
        # one page-locked block a round; its pages are row slices of it
        self._host = []
        for r in range(self.rounds):
            block = host_empty((n_pad, f), torch.float32, pinned)
            block.copy_(torch.from_numpy(np.ascontiguousarray(
                features[r, rank])))
            self._host.append(block)
        self._pages = [[b[i:i + self.page_rows]
                        for i in range(0, n_pad, self.page_rows)]
                       for b in self._host]
        self.n_pages = len(self._pages[0])
        self.round_bytes = n_pad * f * 4
        self.host_bytes = self.rounds * self.round_bytes
        self._side = SideStream(self.device)
        self._inflight: dict[int, tuple] = {}
        self._pending: list[tuple] = []     # device timings not yet read
        self._blocked_s = 0.0
        self._span_s = 0.0
        self._fetches = 0
        self._prefetch_hits = 0
        # a private enabled registry when the caller passes none, so the
        # windowed stats exist without an obs session
        reg = metrics if metrics is not None else MetricsRegistry()
        self._overlap = reg.histogram("pager/overlap_frac", window=window)
        self._fetch_ctr = reg.counter("pager/fetches")
        self._hit_ctr = reg.counter("pager/prefetch_hits")
        reg.gauge("pager/round_bytes").set(self.round_bytes)
        reg.gauge("pager/host_bytes").set(self.host_bytes)

    def prefetch(self, r: int) -> None:
        """Queue round ``r``'s copies to the device (idempotent until the
        round is fetched)."""
        if r in self._inflight:
            return
        dev = torch.empty((self.n_pad, self.n_feats), dtype=torch.float32,
                          device=self.device)
        if self._side.stream is None:       # CPU: copies in program order
            t0 = time.perf_counter()
            self._copy(dev, r)
            self._span_s += time.perf_counter() - t0
            self._inflight[r] = (dev, None, None)
            return
        # the fresh device block may reuse memory that kernels queued on the
        # compute stream still read: the copies start after them; and it is
        # not handed out again while they still write it, should it be freed
        # with the copies in flight (a pager dropped after its last prefetch)
        self._side.follow_compute()
        dev.record_stream(self._side.stream)
        start, done = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record(self._side.stream)
        self._copy(dev, r)
        done.record(self._side.stream)
        self._inflight[r] = (dev, start, done)

    def _copy(self, dev: torch.Tensor, r: int) -> None:
        """Round ``r``'s pages into their rows of ``dev``, one copy a page
        (so the copies are the concatenation)."""
        self._side.copy(dev.view(-1), self._host[r].view(-1),
                        page=self.page_rows * self.n_feats)

    def fetch(self, r: int) -> torch.Tensor:
        """Round ``r``'s ``(n_pad, F)`` features on the device, after the
        compute stream waits for their copies.  Consumes the prefetch."""
        if r in self._inflight:
            self._prefetch_hits += 1
            self._hit_ctr.inc()
        else:
            self.prefetch(r)
        dev, start, done = self._inflight.pop(r)
        self._fetches += 1
        self._fetch_ctr.inc()
        if done is None:
            self._overlap.observe(1.0)
        else:
            stream = torch.cuda.current_stream(self.device)
            before, after = (torch.cuda.Event(enable_timing=True)
                             for _ in range(2))
            before.record(stream)
            SideStream.hand_over(done)
            after.record(stream)
            self._pending.append((start, done, before, after))
        return dev

    def _settle(self) -> None:
        """Read the device timings of the fetches made so far."""
        for start, done, before, after in self._pending:
            after.synchronize()
            span = max(start.elapsed_time(done) / 1e3, 1e-12)
            blocked = max(0.0, before.elapsed_time(after) / 1e3)
            self._span_s += span
            self._blocked_s += blocked
            self._overlap.observe(max(0.0, 1.0 - blocked / span))
        self._pending = []

    def stats(self) -> dict:
        """The reference's keys: counts, page layout, bytes, the blocked and
        copy seconds and the lifetime and windowed overlap shares."""
        self._settle()
        span = self._span_s
        return {
            "fetches": self._fetches,
            "prefetch_hits": self._prefetch_hits,
            "n_pages": self.n_pages,
            "page_rows": self.page_rows,
            "host_kind": self.host_kind,
            "host_bytes": self.host_bytes,
            "round_bytes": self.round_bytes,
            "blocked_s": self._blocked_s,
            "span_s": span,
            "overlap_frac": (0.0 if span == 0.0
                             else max(0.0, 1.0 - self._blocked_s / span)),
            "overlap_frac_window": self._overlap.window_mean,
            "overlap_frac_window_min": self._overlap.window_min,
            "overlap_window_size": self._overlap.window_size,
        }
