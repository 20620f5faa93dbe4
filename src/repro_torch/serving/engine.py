"""ServeEngine: continuous-batching greedy decode over the paged,
block-quantized KV cache (the reference's ``repro.serving.engine``).

One decode step serves every slot at once (static ``max_batch`` shapes):
embed the slots' last tokens, walk the layer stack writing each new KV row
into its page (quantized through the paper's block-wise SR path for
``bits<16``, one seeded ``quant_pack`` launch per layer and stream), and
attend as the reference does: over the quantized cache one page per
online-softmax step (:func:`repro_torch.serving.kvcache.make_page_fetch`
into :func:`repro_torch.models.attention.decode_attend_paged`: one
``dequant_unpack`` launch per layer and page, K and V together, so no
float32 K/V beyond one page exists), and over raw pages for ``bits=16``
(:func:`repro_torch.models.attention.decode_attend` on the gathered
window).  Generated tokens accumulate in a device-side
``(max_batch, gen_cap)`` buffer; the host copies a request's row **once**,
on completion, with no per-token round trip.

Prefill runs per admission group (same-length prompts batch together)
through ``Model.prefill`` (flash-attention kernel on the card), writes the
prompt's KV into the freshly reserved pages via
:func:`repro_torch.serving.kvcache.write_prompt`, and seats the slot state
on the device; one ``torch.cuda.synchronize()`` after it (where the
reference blocks until ready) makes TTFT real.  The host mirrors of the
scheduler advance without reading the card; the decode step takes its
active slots from them.

``obs=`` (an :class:`~repro_torch.obs.session.ObsSession` or an
:class:`~repro_torch.obs.policy.ObsPolicy`) records the reference's
serving telemetry: the spans ``serve/prefill`` (which waits for the card)
and ``serve/decode_step`` (host time: the step's enqueueing), the counters
``serve/prefill_tokens``, ``admitted``, ``completed``, ``rejected`` and
``decode_steps``, the gauge ``serve/pages_in_use`` (its maximum) and the
histograms ``serve/ttft_ms``, ``tpot_ms``, ``queue_depth`` and
``occupancy``.  None of it touches the slot state or the pool, so tokens
and logits are those of a run without it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.engine.seeds import kv_seed
from repro_torch.models import attention as attn
from repro_torch.models.layers import mm, rmsnorm
from repro_torch.obs.session import ObsSession
from repro_torch.serving import kvcache
from repro_torch.serving.kvcache import KVCacheConfig, plan_kv_layout
from repro_torch.serving.scheduler import MODES, Scheduler

#: Families the paged KV cache serves (attention KV caches); the SSM /
#: hybrid state caches and the enc-dec's encoder cache decode through
#: ``repro_torch.launch.serve``'s legacy fixed-batch loop.
KV_FAMILIES = ("dense", "vlm", "moe")


@dataclasses.dataclass
class RequestResult:
    rid: int
    status: str                      # "done" | "rejected"
    tokens: np.ndarray | None = None
    reason: str = ""
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    latency_s: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_decode_fn(model, layout, *, gen_cap: int, collect_logits: bool):
    """The one-token step for every slot: ``step(pool, page_table, state,
    active, written)`` updates ``pool`` and ``state`` in place and returns
    them.  ``active`` (B,) bool is the host's copy of ``state["active"]``
    and ``written`` the active slots' ``(page, offset)`` KV rows, both from
    the scheduler mirrors (a host pool copies those rows back).  Mirrors
    ``Model.decode_step``'s layer math (its FFN is ``Model._ffn``); only
    the KV storage differs."""
    cfg = model.cfg

    @torch.no_grad()
    def step(pool, page_table, state, active, written):
        tokens, pos = state["tokens"], state["pos"]
        dev = tokens.device
        # the active slots' indices, copied to the card once a step, and
        # every layer's K and V seeds (L, 2, B) in one go
        rows = torch.as_tensor(np.flatnonzero(active), device=dev)
        seeds = kv_seed(pos[None, None, :],
                        torch.arange(tokens.shape[0], device=dev),
                        torch.arange(cfg.n_layers, device=dev)[:, None, None],
                        torch.arange(2, device=dev)[None, :, None])
        h = model.embed[tokens]
        for li, lp in enumerate(model.layers):
            x = rmsnorm(h, lp.ln1)
            q, k, v = attn.qkv_project(x, lp.attn, cfg, pos[:, None])
            pool_l = kvcache.layer_view(pool, li)
            kvcache.write_token(pool_l, layout, page_table, pos, active,
                                k[:, 0], v[:, 0], seeds[li, 0], seeds[li, 1],
                                rows=rows)
            kvcache.commit_rows(pool, li, written)
            if layout.quantized:
                fetch = kvcache.make_page_fetch(pool_l, layout, page_table)
                a = attn.decode_attend_paged(
                    q, pos, page_table.shape[1], fetch,
                    n_kv_heads=cfg.n_kv_heads, out_dtype=x.dtype)
            else:
                kf, vf = kvcache.gather_kv_raw(pool_l, layout, page_table)
                a = attn.decode_attend(q, kf, vf, pos, out_dtype=x.dtype)
            # the model's own FFN: the dense MLP, or (MoE) the dense
            # residual under ln3 and the experts under ln2
            h, _ = model._ffn(h + mm(a, lp.attn.wo), lp)
        logits = model._logits(h)[:, -1]                          # (B, V)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        dev_active = state["active"]
        col = state["gen"][rows].to(torch.int64)
        state["out"][rows, col] = next_tok[rows]
        if collect_logits:
            state["logits"][rows, col] = logits[rows]
        state["tokens"] = torch.where(dev_active[:, None], next_tok[:, None],
                                      tokens)
        state["pos"] = pos + dev_active.to(pos.dtype)
        state["gen"] = state["gen"] + dev_active.to(torch.int32)
        state["active"] = dev_active & (state["gen"] < state["target"])
        return pool, state

    return step


def make_prefill_fn(model, layout, *, collect_logits: bool):
    """The admission step: prefill a same-length prompt group, stash its
    KV into the reserved pages, seat the slots (state updated in place).
    ``phys_pages`` and ``slots`` are host arrays."""

    @torch.no_grad()
    def prefill(pool, state, prompts, phys_pages, slots, targets):
        S = prompts.shape[1]
        pad = phys_pages.shape[1] * layout.page_tokens  # page-aligned
        logits, cache = model.prefill(prompts, max_seq=pad)
        kvcache.write_prompt(pool, layout, cache["k"], cache["v"],
                             phys_pages, slots)
        del cache
        dev = prompts.device
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)       # (n,)
        sl = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
        state["tokens"][sl, 0] = tok0
        state["pos"][sl] = S
        state["active"][sl] = True
        state["target"][sl] = torch.as_tensor(np.asarray(targets),
                                              dtype=torch.int32, device=dev)
        state["out"][sl, 0] = tok0
        state["gen"][sl] = 1
        if collect_logits:
            state["logits"][sl, 0] = logits.to(torch.float32)
        return pool, state

    return prefill


class ServeEngine:
    """Continuous-batching serving engine over the paged KV cache, on the
    model's device.

    ``mode="fixed"`` turns the same machinery into the legacy sequential
    fixed-batch loop (admission barriers, see
    :class:`repro_torch.serving.scheduler.Scheduler`).
    """

    def __init__(self, model, *, kv: KVCacheConfig | None = None,
                 max_batch: int = 4, max_queue: int = 64,
                 max_prompt: int = 64, gen_cap: int = 64,
                 mode: str = "continuous", obs=None,
                 collect_logits: bool = False):
        cfg = model.cfg
        if cfg.family not in KV_FAMILIES:
            raise ValueError(
                f"paged-KV serving covers the attention-cache families "
                f"{KV_FAMILIES}; family={cfg.family!r} decodes through "
                "repro_torch.launch.serve's legacy fixed-batch loop")
        if mode not in MODES:
            raise ValueError(f"mode={mode!r} not in {MODES}")
        self.model, self.mode = model, mode
        self.device = model.device
        kv = kv or KVCacheConfig()
        self.layout = plan_kv_layout(kv, n_layers=cfg.n_layers,
                                     n_kv_heads=cfg.n_kv_heads,
                                     d_head=cfg.d_head)
        T = self.layout.page_tokens
        self.max_prompt, self.gen_cap = max_prompt, gen_cap
        self.max_pages_per_slot = -(-(max_prompt + gen_cap - 1) // T)
        self.max_batch = max_batch
        self.collect_logits = collect_logits
        self.session = (obs if isinstance(obs, ObsSession)
                        else ObsSession.from_policy(obs))
        self.pool, self.mechanism = kvcache.place_kv_pool(
            kvcache.init_kv_pool(self.layout, self.device), self.layout)
        self.alloc = kvcache.PageAllocator(kv.n_pages)
        self.sched = Scheduler(max_batch=max_batch, page_tokens=T,
                               allocator=self.alloc, mode=mode,
                               max_queue=max_queue, max_prompt=max_prompt,
                               max_new_cap=gen_cap)
        self._decode = make_decode_fn(model, self.layout, gen_cap=gen_cap,
                                      collect_logits=collect_logits)
        self._prefill = make_prefill_fn(model, self.layout,
                                        collect_logits=collect_logits)

    # ------------------------------------------------------------ plumbing
    def _init_state(self) -> dict:
        B, G, dev = self.max_batch, self.gen_cap, self.device
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                           device=dev)
        st = {"tokens": zeros(B, 1), "pos": zeros(B),
              "active": torch.zeros(B, dtype=torch.bool, device=dev),
              "target": zeros(B), "out": zeros(B, G), "gen": zeros(B)}
        if self.collect_logits:
            st["logits"] = torch.zeros((B, G, self.model.cfg.vocab),
                                       device=dev)
        return st

    def _host_active(self) -> np.ndarray:
        """The slots the device state holds active, from the host mirrors
        (a slot stays active until it has generated its budget)."""
        return np.asarray([s is not None and s.gen < s.max_new
                           for s in self.sched.slots])

    def _step(self, page_table, state) -> dict:
        """One decode step over the active slots; the KV row each writes
        sits at position ``prompt_len + gen - 1`` of its pages."""
        active = self._host_active()
        T = self.layout.page_tokens
        written = []
        for s, on in zip(self.sched.slots, active):
            if on:
                pos = s.prompt_len + s.gen - 1
                written.append((s.pages[pos // T], pos % T))
        self.pool, state = self._decode(self.pool, page_table, state, active,
                                        written)
        return state

    def _admit_group(self, group, state, page_table_np):
        """Prefill one same-prompt-length admission group and seat it."""
        m = self.session
        S = group[0][1].prompt.shape[0]
        npg_prompt = -(-S // self.layout.page_tokens)
        slots = np.asarray([si for si, _, _ in group], np.int32)
        prompts = np.stack([req.prompt for _, req, _ in group]).astype(
            np.int32)
        targets = np.asarray([req.max_new for _, req, _ in group], np.int32)
        phys = np.full((len(group), npg_prompt), self.layout.null_page,
                       np.int32)
        for gi, (si, _, pages) in enumerate(group):
            page_table_np[si, :] = self.layout.null_page
            page_table_np[si, :len(pages)] = pages
            phys[gi, :] = pages[:npg_prompt]
        with m.span("serve/prefill", batch=len(group), prompt_len=int(S)):
            self.pool, state = self._prefill(
                self.pool, state, torch.as_tensor(prompts,
                                                  device=self.device),
                phys, slots, targets)
            _sync(self.device)
        now = time.perf_counter()
        for si, req, _ in group:
            slot = self.sched.slots[si]
            slot.gen = 1
            slot.t_first = now
        m.counter("serve/prefill_tokens").inc(int(prompts.size))
        return state

    # ------------------------------------------------------------ main run
    def run(self, requests) -> dict:
        """Drive a request list (with step-indexed arrivals) to completion;
        returns per-request results plus throughput/latency metrics."""
        with self.session.activate():
            return self._run(list(requests))

    def _run(self, requests) -> dict:
        m = self.session
        B, maxp = self.max_batch, self.max_pages_per_slot
        state = self._init_state()
        page_table_np = np.full((B, maxp), self.layout.null_page, np.int32)
        page_table = torch.as_tensor(page_table_np, device=self.device)
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        results: dict[int, RequestResult] = {}
        arrival_t: dict[int, float] = {}
        step_idx, total_gen, decode_steps = 0, 0, 0
        logits_rows: dict[int, np.ndarray] = {}
        t0 = time.perf_counter()

        def completions(state):
            nonlocal total_gen, page_table
            dirty = False
            for si in range(B):
                slot = self.sched.slots[si]
                if slot is None or not slot.done:
                    continue
                # copied: on the CPU .cpu() is the state itself, which
                # later steps overwrite in place
                toks = state["out"][si, :slot.max_new].cpu().numpy().copy()
                if self.collect_logits:
                    logits_rows[slot.rid] = state["logits"][
                        si, :slot.max_new].cpu().numpy().copy()
                t_done = time.perf_counter()
                ttft = slot.t_first - arrival_t[slot.rid]
                tpot = ((t_done - slot.t_first) / (slot.max_new - 1)
                        if slot.max_new > 1 else 0.0)
                results[slot.rid] = RequestResult(
                    rid=slot.rid, status="done", tokens=toks, ttft_s=ttft,
                    tpot_s=tpot, latency_s=t_done - arrival_t[slot.rid])
                total_gen += slot.max_new
                self.sched.complete(si)
                page_table_np[si, :] = self.layout.null_page
                dirty = True
                m.counter("serve/completed").inc()
                m.histogram("serve/ttft_ms").observe(ttft * 1e3)
                m.histogram("serve/tpot_ms").observe(tpot * 1e3)
            if dirty:
                page_table = torch.as_tensor(page_table_np,
                                             device=self.device)

        while True:
            while pending and pending[0].arrival <= step_idx:
                req = pending.popleft()
                arrival_t[req.rid] = time.perf_counter()
                ok, reason = self.sched.submit(req)
                if not ok:
                    results[req.rid] = RequestResult(
                        rid=req.rid, status="rejected", reason=reason)
                    m.counter("serve/rejected").inc()
            m.histogram("serve/queue_depth").observe(len(self.sched.queue))
            admitted = self.sched.admit()
            if admitted:
                by_len: dict[int, list] = {}
                for entry in admitted:
                    by_len.setdefault(len(entry[1].prompt), []).append(entry)
                for group in by_len.values():
                    state = self._admit_group(group, state, page_table_np)
                page_table = torch.as_tensor(page_table_np,
                                             device=self.device)
                m.counter("serve/admitted").inc(len(admitted))
                m.gauge("serve/pages_in_use").max(self.alloc.used_pages)
            completions(state)
            if self.sched.active_count == 0:
                if self.sched.queue:
                    raise RuntimeError(
                        "admission stalled with an empty batch — a queued "
                        "request's page reservation cannot ever be met")
                if pending:
                    step_idx = max(step_idx + 1, pending[0].arrival)
                    continue
                break
            with m.span("serve/decode_step", step=step_idx):
                state = self._step(page_table, state)
            step_idx += 1
            decode_steps += 1
            self.sched.tick()
            m.counter("serve/decode_steps").inc()
            m.histogram("serve/occupancy").observe(
                self.sched.active_count / B)
            completions(state)

        wall = time.perf_counter() - t0
        ordered = [results[r.rid] for r in
                   sorted(requests, key=lambda r: r.rid)]
        done = [r for r in ordered if r.status == "done"]
        lat = np.asarray([r.latency_s for r in done]) if done else \
            np.zeros((1,))
        out = {
            "results": ordered,
            "wall_s": wall,
            "gen_tokens": total_gen,
            "decode_steps": decode_steps,
            "tokens_per_sec": total_gen / max(wall, 1e-9),
            "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_latency_ms": float(np.percentile(lat, 99) * 1e3),
            "ttft_mean_ms": float(np.mean([r.ttft_s for r in done]) * 1e3)
            if done else 0.0,
            "tpot_mean_ms": float(np.mean([r.tpot_s for r in done]) * 1e3)
            if done else 0.0,
            "rejected": sum(r.status == "rejected" for r in ordered),
            "kv_pool_bytes": self.layout.pool_bytes,
            "kv_f32_pool_bytes": self.layout.f32_pool_bytes,
            "kv_bits": self.layout.bits,
            "kv_mechanism": self.mechanism,
            "mode": self.mode,
        }
        if self.collect_logits:
            out["logits"] = logits_rows
        return out
