"""Slot-based continuous-batching scheduler with admission control (the
reference's ``repro.serving.scheduler``, copied: it is numpy and host
bookkeeping only).

Requests queue FIFO; free decode slots refill from the queue head every
step (``mode="continuous"``), each admission allocating the request's
full page budget up front — admission control is "reserve pages or
wait", so an admitted request can never deadlock mid-decode.  Setting
``mode="fixed"`` recovers the legacy serving loop as a scheduler
configuration: admission waits until every slot is free, then seats a
whole batch, so slots idle until the batch's slowest request drains —
exactly the sequential fixed-batch behavior ``launch.serve`` used to
hard-code (and the baseline the continuous benchmark arm is gated
against).

Submission-time rejects (queue overflow, prompt/gen over the engine's
static caps, page demand exceeding the whole pool) are surfaced as
"rejected" results, never silently dropped.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.serving.kvcache import PageAllocator

MODES = ("continuous", "fixed")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt token ids + a deterministic
    generation budget (``max_new`` counts the prefill's first token)."""
    rid: int
    prompt: np.ndarray
    max_new: int
    arrival: int = 0    # scheduler step at which the request becomes visible


@dataclasses.dataclass
class SlotState:
    """Host mirror of one occupied decode slot (no device syncs: pos/gen
    advance deterministically with every decode tick)."""
    rid: int
    prompt_len: int
    max_new: int
    pages: list
    t_admit: float = 0.0
    t_first: float = 0.0
    gen: int = 0

    @property
    def done(self) -> bool:
        return self.gen >= self.max_new


class Scheduler:
    def __init__(self, *, max_batch: int, page_tokens: int,
                 allocator: PageAllocator, mode: str = "continuous",
                 max_queue: int = 64, max_prompt: int, max_new_cap: int):
        if mode not in MODES:
            raise ValueError(f"mode={mode!r} not in {MODES}")
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        self.max_batch = max_batch
        self.page_tokens = page_tokens
        self.allocator = allocator
        self.mode = mode
        self.max_queue = max_queue
        self.max_prompt = max_prompt
        self.max_new_cap = max_new_cap
        self.slots: list[SlotState | None] = [None] * max_batch
        self.queue: deque[Request] = deque()

    # ------------------------------------------------------------- queries
    @property
    def active_count(self) -> int:
        return sum(s is not None for s in self.slots)

    def pages_needed(self, req: Request) -> int:
        """Whole-horizon page budget: the prompt's S tokens plus the
        max_new-1 decode writes (the first generated token comes out of
        prefill; its KV row is written by the first decode tick)."""
        tokens = len(req.prompt) + req.max_new - 1
        return -(-tokens // self.page_tokens)

    # ----------------------------------------------------------- admission
    def submit(self, req: Request) -> tuple[bool, str]:
        """Admission control at the door; (False, reason) = rejected."""
        if len(self.queue) >= self.max_queue:
            return False, f"queue full ({self.max_queue} waiting)"
        if len(req.prompt) < 1 or len(req.prompt) > self.max_prompt:
            return False, (f"prompt length {len(req.prompt)} outside "
                           f"[1, {self.max_prompt}]")
        if req.max_new < 1 or req.max_new > self.max_new_cap:
            return False, (f"max_new={req.max_new} outside "
                           f"[1, {self.max_new_cap}]")
        need = self.pages_needed(req)
        if need > self.allocator.n_pages:
            return False, (f"needs {need} KV pages; the pool has "
                           f"{self.allocator.n_pages}")
        self.queue.append(req)
        return True, ""

    def admit(self) -> list[tuple[int, Request, list[int]]]:
        """Seat queued requests into free slots, reserving their full
        page budget; stops at the first request the pool cannot yet
        satisfy (FIFO, no overtaking — deterministic replays)."""
        if self.mode == "fixed" and self.active_count:
            return []
        out = []
        for si in range(self.max_batch):
            if self.slots[si] is not None or not self.queue:
                continue
            req = self.queue[0]
            pages = self.allocator.alloc(self.pages_needed(req))
            if pages is None:
                break
            self.queue.popleft()
            self.slots[si] = SlotState(rid=req.rid,
                                       prompt_len=len(req.prompt),
                                       max_new=req.max_new, pages=pages)
            out.append((si, req, pages))
        return out

    def tick(self) -> None:
        """Advance the host mirrors after one decode step (every occupied
        slot generated one token; the jitted step deactivates finished
        slots device-side with the same arithmetic)."""
        for s in self.slots:
            if s is not None and s.gen < s.max_new:
                s.gen += 1

    def complete(self, si: int) -> SlotState:
        """Release a finished slot: pages back to the pool, slot free."""
        slot = self.slots[si]
        if slot is None:
            raise ValueError(f"slot {si} is not occupied")
        self.allocator.free(slot.pages)
        self.slots[si] = None
        return slot
