#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the main path, from ``src/repro_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, timed with CUDA events (cold L2) beside the plain version,
   the one-call PyTorch yardstick where there is one, and the card's bound
   (flash attention at the serving prefill's (80, 1000, 128) and ragged
   shapes, the bf16 tensor-core kernel also bit-identical from call to
   call with at most 1 % of its outputs not bit-equal to the plain
   version's, timed beside float32 and bf16 SDPA; the seeded quant_pack
   and the page dequant_unpack at the KV cache's shapes; RP/IRP also bit-identical from call to call, with the
   tensor-core kernel's bytes bound beside the float32 SIMT bound);
   then a small training run with the kernels against the plain path, and
   the full-size aggregation (spmm) checked for bit-reproducibility;
   (the fused matmul-quant pair at the rp_ratio-0 slice's layer shapes
   is also held against the quant kernels and timed beside its two-pass
   spelling; the quant kernels also at Table 1's flickr shapes, G = 125
   and G = 1000 at 2 bits, whose words are ragged, at 8-bit VM, a
   256-level table, at 42,336 and 21,168 blocks of 256, and at the 8-bit
   AdamW moments' blocks);
4. slice 1: full-graph i-EXACT GraphSAGE training (arxiv-like at full
   size, hidden 256-256, INT2, G=256, RP 8, VM) through ``train_gnn`` on
   the card, with launch counts, the live stash against the byte ledger,
   peak memory within 1 MB of RP8_PEAK, a falling finite loss and a
   bit-identical repeated step; then one profiled step (device time per
   kernel, idle share);
5. slice 2: the same SAGE without RP, ``fused="auto"``, where every layer
   runs the fused pair: the same checks, with 3 fused launches a step and
   none of the unfused quant or RP kernels, then 2 epochs with
   ``fused="off"`` from the same weights (losses within rtol 1e-3, equal
   stash bytes, epoch times and peak memory side by side) and one
   profiled step;
6. slice 4, the rest of the full-graph main path: autoprec on slice 1
   (``bit_budget=2.0``, ``autoprec_refresh=2``, 4 epochs: every width in
   ``BIT_CHOICES``, the allocation within the budget, a bit-identical
   repeat) and where its re-solve's time goes; every layer at 8-bit VM
   for 2 epochs; the mixed widths MIXED_BITS for 2 epochs, and a step
   recompiled from the template's widths to them; Table 1's flickr rows (flickr-like at full size, 89,250
   nodes, SAGE 256-256: FP32, INT2 per-row G = 125, block G/R = 8 and
   INT2+VM, FLICKR_EPOCHS each: test accuracy, epoch times, the M column
   and peak memory), then the VM row again with 8-bit AdamW states.  Each run
   with its launch counts as planned, its live stash equal to the ledger
   (``graph.analysis.live_stash_bytes``: ``activation_memory_report``'s
   for a compressed layer) and a finite, falling loss;
7. slice 10, the mini-batch partition engine through ``train_gnn_batched``
   on phase 4's graph, config and weights: (a) one batch with tight
   padding is ``train_gnn`` bit for bit; (b) the examples recipe (8 bfs
   parts, halo 0, BATCHED_EPOCHS epochs: batches of BATCH_NODES x
   BATCH_EDGES, 8 updates an epoch, launches as planned, the live stash
   equal to ``activation_memory_report``'s batched ledger, a falling loss,
   a bit-identical repeated epoch, epoch times and peak memory beside
   phase 4's) and one profiled update; (c) the README recipe (halo 1,
   ``grad_accum=2``, 2 epochs: HALO_BATCH_NODES, 4 updates an epoch, its
   ledger) and one profiled update; (d) rp_ratio 0, ``fused="auto"`` (3
   fused launches a batch step, none unfused) and ``"off"`` from the same
   weights (losses within rtol 1e-3, the same stash); (e) autoprec at
   ``bit_budget=2.0``, ``autoprec_refresh=2`` on batch 0 (widths in
   ``BIT_CHOICES``, the allocation within the per-batch budget, a
   bit-identical repeat).  The quant, RP and fused kernels of phase 3 also
   run at these batches' shapes;
8. slice 3: serving full-width qwen1.5-4b (random bf16 weights, seed 0),
   cut from 40 layers to SERVE_LAYERS (20) so the whole script keeps
   within 900 s with phase 14 added (phase 8 was ~250 s
   of it at 40), through ``repro_torch.launch.serve``'s engine: 8
   requests of 1000 prompt
   tokens and 32 generated, 4 slots, continuous batching, 4-bit KV pages
   (G=64, 16 tokens a page), decode reading the cache one page per
   online-softmax step.  Every request served with 32 tokens; launch
   counts as planned (at 20 layers flash 40, seeded quant_pack 2,560,
   dequant_unpack 80,600: 62 steps x 20 layers x 65 pages, K and V of a
   page in one launch, no plain attention on the card); the live pool's
   bytes equal the layout's; TTFT,
   TPOT, tokens/s and peak memory of that run, which collects no logits,
   as the launcher runs; two more runs that collect the logits give the
   same tokens and identical, finite logits; at 2 layers of full width the
   prefill logits with the kernel agree with the plain attention on the
   card, and a decode step's logits through the paged read agree with
   ``decode_attend`` over the same pages dequantized by the plain version
   and laid end to end (logged at SERVE_LAYERS too); prefill and decode step
   times, the decode step through the paged read and through the whole-
   window read it replaced in turns, and one profiled prefill and decode
   step;
9. slice 11, the stash arena and offload engine: (a)-(d) run after phase
   7 on phase 4's graph and weights, (e) after phase 8.  (a) ``train_gnn``
   on phase 4's config for 3 epochs under ``offload=None``, ``"device"``,
   ``"host"`` and ``"pinned-paged"``; (b) phase 5's rp_ratio-0
   ``fused="auto"`` config the same way for 2 epochs (the fused backward
   reads the packed words the reader hands back); (c) the config
   uncompressed (every layer's raw f32 input stashed, an 878 MB arena
   against a 699 MB host window) under None, ``"device"`` and
   ``"pinned-paged"`` for 2 epochs; (d) ``train_gnn_batched`` (8 bfs
   parts, halo 0) under None, ``"device"`` and ``"host"`` for 2 epochs.
   Every run counted and checked: launches as planned, losses and params
   bit-identical across placements, the readers' device-resident stash
   within ``device_resident_stash_bytes``, no misaligned packed view,
   epoch times and peak memory logged; then one probe step a placement
   (``host_store_bytes`` the plan's bytes after the forward, 0 after the
   backward; the measured residual bytes, the reference offload
   benchmark's ``ordering_ok``: ``pinned-paged <= device <= None`` at
   (a)-(c)), profiled under the host placements (the side stream's copy
   time hidden under the compute stream's kernels, from the trace).  (e)
   the kernels at its shapes, then phase 8's recipe on 2 requests of 1000
   + 8 tokens under the KV policies ``device``, ``host`` and
   ``pinned-paged``: launches as planned, the pool on the host (pinned for
   ``pinned-paged``) with the layout's bytes, tokens and logits bit-equal
   to ``device``, TTFT, TPOT and peak memory of each;
10. slice 12, the mesh engine, after phase 9 (a)-(d) on phase 4's graph,
   config and weights: (a) ``train_gnn_mesh`` on one rank (8 bfs parts,
   MESH_EPOCHS epochs) is ``train_gnn_batched(shuffle=False)`` bit for bit
   (batches of BATCH_NODES x BATCH_EDGES, 8 rounds an epoch, launches as
   planned, the live stash equal to the mesh ledger, the pager hitting
   every round with a round of BATCH_NODES x 128 floats, epoch times and
   peak memory beside the batched engine's), one profiled round, and a
   round's parts timed apart (``round_shares``: the pager's fetch and
   prefetch, the per-op forward and backward against ``_StashGNN``'s); (b)
   one partition with tight padding is ``train_gnn`` bit for bit; then two
   ranks sharing the card over gloo (``repro_torch.parallel.run_ranks``:
   spawned, a FileStore, every wait bounded by RANKS_TIMEOUT, the kernels
   built here first): (c) ``n_parts = m = 2`` uncompressed for 2 epochs,
   within rtol 2e-4 / atol 2e-5 of ``train_gnn`` (no edge dropped, a halo
   width above 0, the bytes sent the program's); (d) 8 compressed parts in
   4 rounds for MESH_EPOCHS epochs: a falling loss, each rank's stash the
   ledger, the bytes sent ``halo_bytes_per_epoch`` an epoch, the pager
   hitting, launches as planned, and one profiled round on rank 0 (the
   exchange's device copies and host time); (e) ``train_gnn_batched`` over
   the two ranks is ``grad_accum=2`` in one process bit for bit.  Both
   ranks end every run with bit-equal parameters;
11. slice 13, observability (``repro_torch.obs``): (a)-(d) after phase 10 on
   phase 4's graph, config and weights, (e) after phase 9 (e).  (a)
   ``engine.runner.run`` on the full graph for OBS_EPOCHS epochs with obs
   off, then with spans, metrics and the quant-health probe at epochs 0
   and 2: losses, params and stash bit-identical, launches as planned with
   the 2 probes (one RP, quant_pack and dequant_unpack a layer each), each
   layer's measured SR variance beside its Eq. 10 prediction, the probe's
   time alone and the peak memory with it on and off, and the trace
   exported to build/obs/ in the reference's schemas; (b) OVERHEAD_PAIRS
   pairs of obs-off / trace+metrics-on runs: the median epoch time on over
   off below OVERHEAD_LIMIT; (c) autoprec at ``bit_budget=2.0`` with
   ``calibration="obs"``: widths in BIT_CHOICES within the budget, and the
   re-solve's time beside ``calibration="probe"``'s; (d) phase 10 (a)'s
   one-rank mesh for 2 epochs, obs on bit-identical to off, with a
   ``mesh/round`` and a ``pager/fetch`` span and an overlap observation a
   round and ``halo/bytes`` the bytes sent; (e) phase 9 (e)'s ``device``
   recipe with ``--obs``: its tokens and logits, 2 requests completed, 2
   TTFT observations.  The phase stays under PHASE11_LIMIT_S;
12. slice 14, the training launcher (``repro_torch.launch.train``) in
   process, after phase 11 (e): (a) the graph half at phase 4's size:
   ``--graph-batches 8 --steps 3`` equal to ``engine.runner.run`` on the
   same plan bit for bit, its printed peak and live stash equal to
   ``activation_memory_report``; ``--mesh-parts 8 --steps 2`` on one rank
   equal to ``train_gnn_batched(shuffle=False)`` bit for bit; the device
   arena with autoprec at ``--bit-budget 2.0`` and ``--obs --trace-out``
   (widths within the budget, the arena line, the trace files); (b) the
   LM half on qwen1.5-4b at full width and 40 layers under ``act`` (B 2 x
   1024, 5 steps: a finite, falling loss, 40 quant_pack and dequant_unpack
   launches a step, step times, the peak beside the reckoning, one
   profiled step), then at 8 layers 2 steps each of none / remat / act
   from the same weights (peak, step times, and the loss graph's residual
   bytes, which must order act < remat < none), and act with the
   pinned-paged stash bit-identical to the device stash; (c) at the smoke
   width, 4 steps checkpointed every 2, then ``--steps 6`` in the same
   directory resumes at step 4 and equals an uninterrupted 6-step run bit
   for bit, and ``--fail-at 3`` raises and leaves ``step_2`` loadable.
   The phase stays under PHASE12_LIMIT_S;
13. slice 15, the MoE family, after phase 12: first flash at the MoE
   prefill's (256, 1000, 128) bf16 beside SDPA, the seeded quant_pack and
   page dequant_unpack at 4 KV heads and the 8-bit AdamW moments of a
   (128, 4096, 1536) expert stack, each against its plain version and
   timed; (a) qwen3-moe-235b-a22b at full width (128 experts top-8,
   64 / 4 heads, qk-norm) cut to MOE_SERVE_LAYERS layers, seed-0 weights
   (the reckoned bytes beside the model's), on phase 8's traffic through
   the launcher's engine: 8 requests of 32 tokens, launches by phase 8's
   formula, no plain attention on the card, the pool's bytes the
   layout's, a run collecting logits with the same tokens and finite
   logits, TTFT / TPOT / tokens/s / peak, one profiled decode step and
   prefill; at 2 layers of the same weights the prefill logits with the
   kernel against the plain attention and a paged decode step against
   the plain-dequantized window (phase 8's bands); (b) layer 0 at the
   prefill's (4, 1000, 4096): the card's routing (idx, keep, slot) equal
   to the host's recomputation from the card's probabilities, y on
   MOE_SAMPLE tokens against a float32 loop over each token's kept
   experts within MOE_BAND, the dropped pairs at C = 80, and the layer's
   time at the prefill's and a decode step's shape (the experts' share of
   a decode step); (c) arctic-480b at full width (its dense FFN residual)
   and ARCTIC_LAYERS layers serving 2 requests of 256 + 8 tokens: tokens,
   finite logits, launches as planned; (d) ``launch.train`` on
   qwen3-moe at full width cut to 1 layer (MOE_LM_ARGV: remat, 8-bit
   AdamW, B 8 x 512 in the config's grad_accum 8 micro-batches, 5 steps):
   a finite loss and aux every step, a nonzero router gradient, the
   moments' launches as planned.  The phase stays under PHASE13_LIMIT_S;
14. slice 16, the SSM, hybrid and enc-dec families, after phase 13: first
   the kernels at the families' shapes against their plain versions,
   timed (FAMILY_FLASH: bf16 flash at the encoder's (64, 1024, 64)
   non-causal, a decode step's cross-attention (64, 1, 64) over 1024 keys
   and the hybrid's shared block (128, 1024, 128) causal, beside SDPA; the
   INT2 stash at FAMILY_STASH's block counts); then, each at full width
   and depth with seed-0 weights, served through the launcher's legacy
   loop on phase 8's traffic (LEGACY_ARGV: 8 requests of 1024 + 32
   tokens, 4 a batch; launches LEGACY_FLASH, no plain attention on the
   card, TTFT, decode tokens/s, the peak and one profiled decode step):
   (a) mamba2-780m (attention-free: no launch), a second run with the
   same tokens, layer 0's real SSD inputs through ``ssd_chunked``
   against a float64 recurrence on the host (SSD_BAND) and, on 2 layers,
   prefill of 1024 tokens against prefill of PREFIX_TOKENS and
   teacher-forced decode steps (logits 0.1, conv cache and SSD state
   STATE_BAND); (b) zamba2-1.2b (6 shared sites), with the 3-layer
   model's prefill logits through the kernel against the plain attention
   (0.1); (c) seamless-m4t-large-v2 (24 + 24 layers), with the 2 + 2
   layer model's encoder output and a decode step's logits through the
   kernel against the plain attention, and a decode step's time in
   cross-attention; (d) ``launch.train`` at full width and depth
   (FAMILY_LM: mamba2 act B 4 x 2048 5 steps, zamba2 act B 2 x 2048 2
   steps, seamless remat B 2 x 1024 with ``enc_embeds`` 2 steps, float32
   moments): finite losses and gradients every step, the INT2 stash
   launched once a Mamba-2 layer and step each way, mamba2's loss
   falling, then mamba2 at LM_LAYERS_SHORT layers under none / remat /
   act with the loss graph's residual bytes act < remat < none.  The
   phase stays under PHASE14_LIMIT_S;
15. slice 17, the static checker and the examples, after phase 14: (a)
   ``python -m repro_torch.staticcheck --ci --no-cache --device cuda`` in
   a subprocess exits 0 with no finding over the 34-case plan matrix,
   then the same saved-tensor audit in this process with its launches as
   planned (``matrix_planned``), and the kernel contracts over every
   launch shape of this script (``smoke_launches``); (b) the audit at
   phase 4's config on the full graph under AUDIT_PLACEMENTS and the
   mesh's per-op forward on one rank over the whole graph as one
   partition: the ledger equal to ``graph.analysis.live_stash_bytes``,
   the allocator's growth in requested bytes over a forward, less the
   logits, within ALLOC_SLACK a stash tensor of the saved tensors' device
   bytes (none for the host placements), the host store drained by the
   backward; (c) the four ``examples/torch_*.py`` through their ``main``
   (the GNN driver at EXAMPLE_GNN_ARGV, both serving archs of
   EXAMPLE_SERVE_ARCHS, the LM at EXAMPLE_LM_ARGV), counted: finite
   losses, the GNN rows' M column equal to ``activation_memory_report``;
   then the quant kernels at the GNN driver's G = 32 and G = 2048 shapes
   (EXAMPLE_QUANT), bit-equal to the plain version and timed.  The phase
   stays under PHASE15_LIMIT_S;
16. a JSON line of per-kernel numbers (phase 13's shapes under
   ``moe_shapes``, phase 14's under ``family_shapes``, phase 15's under
   ``example_shapes``), then ``{"ok": true, "device": ...}``.

It imports nothing of JAX; without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# operations/s outside the tensor cores, and dense TF32 and bf16 on the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12
PEAK_BF16_OPS_PER_S = 989e12

N_NODES = 169_343                 # arxiv_like(scale=1.0)
#: Phase 7's padded batches of arxiv_like(1.0) (make_subgraph_batches,
#: 8 bfs parts, seed 0, node/edge multiples 64/256): halo 0 and halo 1.
BATCH_NODES, BATCH_EDGES = 21_184, 96_768
HALO_BATCH_NODES = 132_032
FLICKR_NODES = 89_250             # flickr_like(scale=1.0)
#: Epochs of each flickr Table-1 row: at the default lr of 5e-3 the FP32
#: row's loss overshoots at epoch 1 (2.084, 7.347, 3.793 over 3 epochs on
#: an H100), so a run must be longer for its loss to fall below its start.
#: The JAX reference overshoots the same way at these widths
#: (tests/test_torch_table1.py::test_flickr_fp32_overshoot_matches_reference).
FLICKR_EPOCHS = 10
#: A mixed allocation of the arxiv slice's widths, pinned (autoprec chose
#: the uniform 2 bits at budget 2.0 there).
MIXED_BITS = (8, 1, 4)
EPOCHS = 5
#: Slice 1's peak device memory over its 5 epochs and 2 repeats with the
#: segment-sum spmm (graph/models.SPMM_MAX_EDGES).  The kernels allocate
#: nothing; the caching allocator's reuse of blocks left by the checks
#: before phase 4 moves the peak by under 1 MB, which the check allows.
RP8_PEAK = 1_855_404_032


def log(*args):
    print(*args, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def bound(nbytes: float, ops: float,
          peak_ops: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work, and which of bytes or operations set
    it; ``peak_ops``: the rate of the units that do the operations."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, flush, iters: int = 20) -> float:
    """Median ms of ``fn`` over ``iters`` launches, CUDA events around each,
    with the L2 cache overwritten before every launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: The quant kernels' shapes beyond slice 1's 2-bit blocks of 256 (n_blocks,
#: G, bits, table): Table 1's flickr rows at 89,250 nodes (layer 0's 125
#: columns after RP 8 and layers 1-2's 64, as G = 125 and G = 1000 blocks:
#: ragged words), an autoprec 8-bit layer of the arxiv slice with its
#: 256-level VM table (42,336 and 21,168 blocks of 256), and the 8-bit
#: AdamW moments of the flickr SAGE (W0 1000x256, W1 512x256, W2 512x7 and
#: a bias: 1,000, 512, 14 and 1 blocks of 256, uniform levels).
EXTRA_QUANT = (("flickr", 89_250, 125, 2, None),
               ("flickr", 89_250, 125, 2, "vm"),
               ("flickr", 45_696, 125, 2, None),
               ("flickr", 45_696, 125, 2, "vm"),
               ("flickr", 11_157, 1000, 2, None),
               ("flickr", 5_712, 1000, 2, None),
               ("vm8", 42_336, 256, 8, "vm"),
               ("vm8", 21_168, 256, 8, "vm"),
               ("adamw8", 1_000, 256, 8, None),
               ("adamw8", 512, 256, 8, None),
               ("adamw8", 14, 256, 8, None),
               ("adamw8", 1, 256, 8, None),
               # phase 12's LM stash: B 2 x 1024 tokens x 2560 / G 256
               ("lm", 20_480, 256, 2, None))


#: Phase 7's 2-bit VM blocks of 256: the RP-8 stashes of a halo-0 batch
#: (21,184 rows at 32 and 64 columns after RP) and of a halo-1 batch
#: (132,032 rows), and the rp_ratio-0 "off" stashes of a halo-0 batch
#: (21,184 x 256 and x 512).
BATCH_QUANT_BLOCKS = (2_648, 5_296, 16_504, 33_008, 21_184, 42_368)


def quant_case(torch, qk, ref, n_blocks, G, bits, lv, flush, gen,
               plain_iters: int = 20) -> tuple:
    """quant_pack / dequant_unpack at one shape: bit-equal to the plain
    version, then timed beside it (over ``plain_iters`` launches) and the
    bound.  Returns the two rows."""
    from repro_torch.core.pack import packed_len

    x = torch.randn((n_blocks, G), device="cuda", generator=gen) * 2.3
    pk, zk, rk = qk.quant_pack(x, bits, 1234, lv)
    pr, zr, rr = ref.quantize_packed(x, bits, 1234, lv)
    torch.cuda.synchronize()
    tag = (f"{n_blocks}x{G}" + (f" int{bits}" if bits != 2 else "")
           + f" {'vm' if lv else 'uniform'}")
    if not (torch.equal(pk, pr) and torch.equal(zk, zr)
            and torch.equal(rk, rr)):
        raise AssertionError(f"quant_pack {tag}: not bit-equal to the plain "
                             "version")
    dk = qk.dequant_unpack(pk, zk, rk, bits, G, lv)
    dr = ref.dequantize_packed(pr, zr, rr, bits, G, lv)
    # the kernel's triplet read back through the plain decoder: any
    # differing word, zero or range shows as a value error
    q_err = max(float((zk - zr).abs().max()), float((rk - rr).abs().max()),
                float((ref.dequantize_packed(pk, zk, rk, bits, G, lv)
                       - dr).abs().max()))
    torch.cuda.synchronize()
    # bit-equal by construction (the same roundings in the same order);
    # allowed 1e-6 in case a library kernel fuses differently
    d_err = float((dk - dr).abs().max())
    if d_err > 1e-6:
        raise AssertionError(f"dequant_unpack {tag}: max abs err {d_err}")
    q_bytes = n_blocks * (G * 4 + packed_len(G, bits) * 4 + 8)
    # the function's own work an element: ~18 operations (the murmur3 hash
    # ~9; normalize, clip, floor and SR compare ~7; the pack 2), and 16
    # more over a table of more than 16 levels (8 search steps of a compare
    # and a select); 4 to dequantize.  The vector kernels issue 41 SASS
    # instructions an element to quantize with uniform levels, 82 with VM,
    # 9 and 14 to dequantize (`scripts/kernel_times.py quant --sass`): at
    # ~33.5 T lane-instructions/s the uniform quantizer's issue time is
    # about its bytes' time, VM twice it
    ops = 18 + (16 if lv and len(lv) > 16 else 0)
    q_bound = bound(q_bytes, ops * n_blocks * G)
    d_bound = bound(q_bytes, 4 * n_blocks * G)
    q = dict(ms=time_ms(torch, lambda: qk.quant_pack(x, bits, 1234, lv), flush),
             plain_ms=time_ms(torch, lambda: ref.quantize_packed(x, bits, 1234, lv), flush, plain_iters),
             bound_ms=q_bound[0], bound_by=q_bound[1], max_abs_err=q_err,
             library_ms=None, bytes=q_bytes)
    d = dict(ms=time_ms(torch, lambda: qk.dequant_unpack(pk, zk, rk, bits, G, lv), flush),
             plain_ms=time_ms(torch, lambda: ref.dequantize_packed(pr, zr, rr, bits, G, lv), flush, plain_iters),
             bound_ms=d_bound[0], bound_by=d_bound[1], max_abs_err=d_err,
             library_ms=None, bytes=q_bytes)
    log(f"quant_pack     {tag}: bit-equal, max abs err {q_err}; {q}")
    log(f"dequant_unpack {tag}: max abs err {d_err}; {d}")
    return tag, q, d


def check_quant(torch, qk, ref, levels, flush, gen) -> dict:
    """quant_pack / dequant_unpack at the main path's block counts: slice
    1's 2-bit blocks of 256 (uniform and VM), phase 7's
    (BATCH_QUANT_BLOCKS), then EXTRA_QUANT (ragged words, the 256-level
    table, the 8-bit AdamW moments and the LM's layer stash)."""
    from repro_torch.core.variance import optimize_levels

    cases = [(n, 256, 2, lv) for n in (21_168, 42_336)
             for lv in (None, levels)]
    cases += [(n, 256, 2, levels) for n in BATCH_QUANT_BLOCKS]
    # flickr's VM table is its rows' (CN_[1/D] at D = 125 // 8), VM-8's
    # the arxiv template's at 8 bits (D = 256 // 8)
    tables = {"flickr": optimize_levels(125 // 8, 2),
              "vm8": optimize_levels(256 // 8, 8)}
    cases += [(n, G, bits, tables[what] if vm else None)
              for what, n, G, bits, vm in EXTRA_QUANT]
    rows = {}
    for n_blocks, G, bits, lv in cases:
        tag, q, d = quant_case(torch, qk, ref, n_blocks, G, bits, lv, flush,
                               gen)
        rows[("quant_pack", tag)] = q
        rows[("dequant_unpack", tag)] = d
    return rows


#: Rows RP and IRP run at: the full graph, phase 7's halo-0 and halo-1
#: batches.
RP_ROWS = (N_NODES, BATCH_NODES, HALO_BATCH_NODES)


def check_rp(torch, rk, ref, rpmod, flush, gen) -> dict:
    """RP and IRP at the main path's shapes (RP_ROWS rows), rtol/atol 2e-4
    (the kernel sums two TF32 parts of x times +-1 on the tensor cores,
    cuBLAS the float32 products, each in its own order), and bit-identical
    from call to call.
    bound_ms is the bound the tensor-core kernel is held to: the bytes, or
    the product's 2*M*K*N operations at the TF32 peak of 495 TFLOP/s,
    whichever is larger (the bytes, at these shapes); f32_bound_ms, logged
    beside it, is the bound of a float32 SIMT product at 67 TFLOP/s."""
    out = {}
    for rows, d_in, r in [(m, d, r) for m in RP_ROWS
                          for d, r in ((256, 32), (512, 64))]:
        for name in ("rp_project", "irp_project"):
            k, n = (d_in, r) if name == "rp_project" else (r, d_in)
            x = torch.randn((rows, k), device="cuda", generator=gen)
            if name == "rp_project":
                kern = lambda: rk.rp_project(x, 77, r)
                plain = lambda: ref.rp_project(x, 77, r)
                mat = rpmod.rp_matrix(77, d_in, r, "cuda")
            else:
                kern = lambda: rk.irp_project(x, 77, d_in)
                plain = lambda: ref.irp_project(x, 77, d_in)
                mat = rpmod.rp_matrix(77, d_in, r, "cuda").T.contiguous()
            yk, again, yr = kern(), kern(), plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(yk, yr, rtol=2e-4, atol=2e-4)
            if not torch.equal(yk, again):
                raise AssertionError(f"{name}: two calls differ")
            err = float((yk - yr).abs().max())
            nbytes = rows * (k + n) * 4
            flops = 2 * rows * k * n
            b = bound(nbytes, flops, PEAK_TF32_OPS_PER_S)
            row = dict(ms=time_ms(torch, kern, flush),
                       plain_ms=time_ms(torch, plain, flush),
                       library_ms=time_ms(torch, lambda: torch.matmul(x, mat), flush),
                       bound_ms=b[0], bound_by=b[1],
                       f32_bound_ms=bound(nbytes, flops)[0],
                       max_abs_err=err, bytes=nbytes, flops=flops)
            tag = f"{rows}x{k}->{n}"
            log(f"{name:14s} {tag}: within 2e-4, bit-identical repeat; {row}")
            out[(name, tag)] = row
    return out


FUSED_LAYERS = ((256, 256), (512, 256), (512, 40))   # slice 2: (D, N)


def aligned_excess(torch, fk, qk, ref, levels, d, n, gen,
                   rows: int = N_NODES) -> float:
    """The backward where no rounding error cancels, at ``rows`` rows (the
    slice's N_NODES: its longest row ranges): every stash row the INT2
    stash of one row of x, every g row one |N(0, 1)| row.  Returns
    max |dw - exact| / (1e-4 * |x_hat|^T |g|), the exact product (float64)
    being ``rows`` times the one row's; above 1 leaves the band."""
    G = 256
    one = qk.quant_pack((torch.randn((1, d), device="cuda", generator=gen)
                         * 1.7).reshape(-1, G), 2, 99, levels)
    g1 = torch.randn((1, n), device="cuda", generator=gen).abs()
    dw = fk.dequant_matmul(one[0].repeat(rows, 1), one[1].repeat(rows),
                           one[2].repeat(rows), g1.repeat(rows, 1), 2,
                           G, d, levels).double()
    x1 = ref.dequantize_packed(*one, 2, G, levels).reshape(1, d).double()
    exact = rows * (x1.T @ g1.double())
    scale = rows * (x1.abs().T @ g1.double())
    return float(((dw - exact).abs() / (1e-4 * scale + 1e-300)).max())


def check_fused(torch, fk, qk, ref, levels, flush, gen) -> dict:
    """matmul_quant / dequant_matmul at the rp_ratio-0 slice's three layer
    shapes, at the full graph's rows and at phase 7's halo-0 batch's.  The
    forward's stash must be bit-equal to the plain version and to the
    quant_pack kernel on the same x, its y within 2e-4 of cuBLAS
    (three TF32 products of split x and w on the tensor cores), and two
    calls must give the same bits; the backward within 1e-4 * (|x_hat|^T
    |g|) elementwise of the plain version (a long row sum in another order),
    also where no rounding error cancels (aligned_excess), and bit-identical
    from call to call.  Timed beside the plain version,
    the product alone in one torch.matmul (library_ms), and the two-pass
    spelling each replaces (unfused_ms: cuBLAS + quant_pack, or
    dequant_unpack + cuBLAS), with the card's name and power limit in each
    row.  Each bound_ms is the tensor-core kernel's: the largest of the
    bytes, the product's 2*M*D*N at the TF32 (forward) or bf16 (backward)
    peak, and the quantizer's ~18 or the dequantizer's ~4 operations an
    element at the float32 rate; f32_bound_ms, logged beside it, is the
    bound of a float32 SIMT product (67 TFLOP/s)."""
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    out, G, smi = {}, 256, card()
    for rows, d, n in [(m, d, n) for m in (N_NODES, BATCH_NODES)
                       for d, n in FUSED_LAYERS]:
        x = torch.randn((rows, d), device="cuda", generator=gen) * 1.7
        w = torch.randn((d, n), device="cuda", generator=gen) / d ** 0.5
        g = torch.randn((rows, n), device="cuda", generator=gen) / 400
        tag = f"{rows}x{d}@{d}x{n}"
        y, *stash = fk.matmul_quant(x, w, 2, 99, levels, group_size=G)
        y_p, *stash_p = ref.matmul_quantize_packed(x, w, 2, 99, levels,
                                                   group_size=G)
        stash_q = qk.quant_pack(x.reshape(-1, G), 2, 99, levels)
        again = fk.matmul_quant(x, w, 2, 99, levels, group_size=G)
        torch.cuda.synchronize()
        for a, b, c in zip(stash, stash_p, stash_q):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"matmul_quant {tag}: stash not "
                                     "bit-equal to the plain version and "
                                     "quant_pack")
        if not all(torch.equal(a, b) for a, b in zip((y, *stash), again)):
            raise AssertionError(f"matmul_quant {tag}: two calls differ")
        del again
        torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
        y_err = float((y - y_p).abs().max())
        dw = fk.dequant_matmul(*stash, g, 2, G, d, levels)
        again = fk.dequant_matmul(*stash, g, 2, G, d, levels)
        dw_p = ref.dequant_matmul_packed(*stash_p, g, 2, G, d, levels)
        x_hat = ref.dequantize_packed(*stash_p, 2, G, levels).reshape(-1, d)
        scale = x_hat.abs().T @ g.abs()
        dw_err = float((dw - dw_p).abs().max())
        if not torch.equal(dw, again):
            raise AssertionError(f"dequant_matmul {tag}: two calls differ")
        if not bool(((dw - dw_p).abs() <= 1e-4 * scale).all()):
            raise AssertionError(f"dequant_matmul {tag}: outside 1e-4 of "
                                 f"|x_hat|^T|g| (max abs err {dw_err})")
        aligned = aligned_excess(torch, fk, qk, ref, levels, d, n, gen,
                                 rows)
        if not aligned <= 1.0:
            raise AssertionError(f"dequant_matmul {tag}: aligned errors "
                                 f"{aligned} of the 1e-4 band")
        nb = rows * d // G
        stash_bytes = nb * (G * 2 // 8) + 8 * nb
        flops = 2 * rows * d * n
        # forward: x and w read, y and the stash written; the product at
        # the TF32 peak, ~18 operations an element to quantize (as
        # check_quant counts) at the float32 rate, whichever takes longest
        f_bytes = 4 * (rows * d + d * n + rows * n) + stash_bytes
        f_bound = max(bound(f_bytes, flops, PEAK_TF32_OPS_PER_S),
                      bound(f_bytes, 18 * rows * d), key=lambda b: b[0])
        # backward: the stash and g read, dw written; the product at the
        # bf16 peak (three bf16 products of split x_hat and g on the tensor
        # cores), ~4 operations an element to dequantize at the float32
        # rate, whichever takes longest
        b_bytes = stash_bytes + 4 * (rows * n + d * n)
        b_bound = max(bound(b_bytes, flops, PEAK_BF16_OPS_PER_S),
                      bound(b_bytes, 4 * rows * d), key=lambda b: b[0])
        f = dict(ms=time_ms(torch, lambda: fk.matmul_quant(x, w, 2, 99, levels, group_size=G), flush),
                 plain_ms=time_ms(torch, lambda: ref.matmul_quantize_packed(x, w, 2, 99, levels, group_size=G), flush),
                 library_ms=time_ms(torch, lambda: torch.matmul(x, w), flush),
                 unfused_ms=time_ms(torch, lambda: (torch.matmul(x, w), qk.quant_pack(x.reshape(-1, G), 2, 99, levels)), flush),
                 bound_ms=f_bound[0], bound_by=f_bound[1],
                 f32_bound_ms=bound(f_bytes, flops + 18 * rows * d)[0],
                 max_abs_err=y_err, flops=flops, bytes=f_bytes, card=smi)
        b = dict(ms=time_ms(torch, lambda: fk.dequant_matmul(*stash, g, 2, G, d, levels), flush),
                 plain_ms=time_ms(torch, lambda: ref.dequant_matmul_packed(*stash_p, g, 2, G, d, levels), flush),
                 library_ms=time_ms(torch, lambda: torch.matmul(x_hat.T, g), flush),
                 unfused_ms=time_ms(torch, lambda: torch.matmul(qk.dequant_unpack(*stash, 2, G, levels).reshape(-1, d).T, g), flush),
                 bound_ms=b_bound[0], bound_by=b_bound[1],
                 f32_bound_ms=bound(b_bytes, flops + 4 * rows * d)[0],
                 max_abs_err=dw_err, aligned_excess=aligned, flops=flops,
                 bytes=b_bytes, scratch_bytes=fk.scratch_nbytes(rows, d, n),
                 splits=fk.splits(rows, d, n)[0], card=smi)
        log(f"matmul_quant   {tag}: stash bit-equal, bit-identical repeat, y "
            f"max abs err {y_err}; {f}")
        log(f"dequant_matmul {tag}: bit-identical repeat, max abs err "
            f"{dw_err}, aligned errors {aligned} of the band; {b}")
        out[("matmul_quant", tag)] = f
        out[("dequant_matmul", tag)] = b
        del x, w, g, y, y_p, stash, stash_p, stash_q, dw, again, dw_p, x_hat
        del scale
    return out


def check_spmm(torch, g, flush, gen) -> None:
    """The aggregation at full size (not a TPU kernel, a library call): the
    port's segment-sum spmm must give the same bits on every call.
    cuSPARSE's CSR product on the same matrix is timed beside it as the
    yardstick the port gave up, with its own run-to-run spread."""
    from repro_torch.graph.models import device_graph, spmm

    a = device_graph(g, "sage", "cuda").adj.fwd
    csr = torch.sparse_csr_tensor(a.offsets, a.cols, a.vals,
                                  (g.n_nodes, g.n_nodes),
                                  check_invariants=False)
    for f in (128, 256):
        h = torch.randn((g.n_nodes, f), device="cuda", generator=gen)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ours = [spmm(h, a) for _ in range(4)]
        transient = torch.cuda.max_memory_allocated() - base - 4 * h.nbytes
        if not all(torch.equal(ours[0], o) for o in ours[1:]):
            raise AssertionError(f"spmm F={f} is not bit-reproducible")
        lib = [csr @ h for _ in range(4)]
        spread = max(float((lib[0] - o).abs().max()) for o in lib[1:])
        log(f"spmm F={f}: bit-reproducible, {len(a.parts)} row runs, "
            f"peak transient beyond its outputs {transient} bytes, "
            f"{time_ms(torch, lambda: spmm(h, a), flush):.4f} ms; cuSPARSE "
            f"CSR {time_ms(torch, lambda: csr @ h, flush):.4f} ms, run-to-run "
            f"spread {spread}, max diff to ours "
            f"{float((lib[0] - ours[0]).abs().max())}")


def check_small_training(torch, train_gnn, cfg, small_graph) -> None:
    """Three epochs with the kernels against the plain path on the CPU, from
    the same weights: losses within rtol 1e-3 (matmul summation order
    differs, and a last-ulp difference can flip a rare SR code)."""
    from repro_torch.graph.models import GNN

    model = GNN(cfg, small_graph.n_feats,
                generator=torch.Generator().manual_seed(1))
    on_card = train_gnn(small_graph, cfg, n_epochs=3, seed=0, params=model,
                        impl="cuda", device="cuda")["history"]
    on_cpu = train_gnn(small_graph, cfg, n_epochs=3, seed=0, params=model,
                       device="cpu")["history"]
    a = [h[1] for h in on_card]
    b = [h[1] for h in on_cpu]
    if not all(math.isclose(x, y, rel_tol=1e-3) for x, y in zip(a, b)):
        raise AssertionError(f"small run: card losses {a} vs CPU {b}")
    log(f"small arxiv-like ({small_graph.n_nodes} nodes) losses: card {a} "
        f"cpu {b}")


#: Name fragments of the port's own kernels: a profile lists them below
#: its top rows too, so each one's device time is read in every profile.
OWN_KERNELS = ("quant_vec_kernel", "quant_scalar_kernel", "rp_kernel",
               "matmul_quant_kernel", "dequant_matmul_kernel", "tree_sum",
               "flash_")


def log_profile(rows, top: int) -> None:
    """Device time by kernel, largest first: the first ``top`` rows and
    every row of the port's own kernels."""
    for i, (ms, count, key) in enumerate(rows):
        if i < top or any(k in key for k in OWN_KERNELS):
            log(f"  {ms:9.3f} ms  x{count:<5d} {key[:100]}")


def profile_call(torch, fn, what: str, top: int = 15) -> None:
    """Where one call of ``fn`` (a training step) goes: device time per
    kernel name (torch.profiler, CUPTI) and the device's idle share of its
    wall time, after one warm-up call; and the peak device memory the call
    adds to what was allocated before it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profiled {what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} "
        f"ms, idle share {1 - busy / wall_ms:.3f}, peak "
        f"{torch.cuda.max_memory_allocated() - base} bytes above the "
        f"{base} allocated before it")
    log_profile(rows, top)


def profile_step(torch, g, cfg, model) -> None:
    """Where one full-graph training step's time goes (profile_call).  Runs
    after the main path's launch counts were read."""
    from repro_torch.engine.compile import CompiledFull
    from repro_torch.graph.models import device_graph
    from repro_torch.optim import AdamWConfig

    step = CompiledFull(device_graph(g, cfg.arch, "cuda"), cfg, model,
                        AdamWConfig(lr=5e-3))
    epochs = iter(range(2))
    profile_call(torch, lambda: step.step(next(epochs)), "step")


FUSED = ("matmul_quant", "dequant_matmul")
#: Slice 2's live stash per layer (graph/analysis.saved_bytes_per_layer at
#: 169,343 nodes, SAGE 128 -> 256 -> 256 -> 40, INT2, G=256, no RP).
RP0_LEDGER = [17_611_676, 29_804_372, 24_385_396]


def slice_rp0(torch, g, cfg, model0, wrappers, saved_bytes_per_layer) -> dict:
    """Slice 2: the same SAGE without RP, fused="auto", where every layer
    is eligible for the fused pair.  Five epochs and two one-epoch repeats
    with the counts set to 0 just before and read just after; then two
    epochs with fused="off" from the same weights as the two-pass
    reference; then one profiled step.  Returns the launch counts."""
    from repro_torch.graph.train import train_gnn

    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = train_gnn(g, cfg, n_epochs=EPOCHS, seed=0, params=model0,
                    fused="auto")
    rep_a = train_gnn(g, cfg, n_epochs=1, seed=0, params=model0, fused="auto")
    rep_b = train_gnn(g, cfg, n_epochs=1, seed=0, params=model0, fused="auto")
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    steps = EPOCHS + 2
    log(f"[rp0 fused=auto] launches over {steps} steps: {launches}")
    for name, n in launches.items():
        want = 3 * steps if name in FUSED else 0
        if n != want:
            raise AssertionError(f"[rp0] {name}: {n} launches, expected "
                                 f"{want}")
    for epoch, loss, ms in res["history"]:
        log(f"[rp0 fused=auto] epoch {epoch}: loss {loss!r} {ms:.3f} ms")
    log(f"[rp0 fused=auto] val_acc {res['val_acc']} test_acc "
        f"{res['test_acc']} max_memory_allocated {peak} bytes")
    ledger = [r["compressed_bytes"]
              for r in saved_bytes_per_layer(cfg, g.n_feats, g.n_nodes)]
    log(f"[rp0] live stash bytes per layer {res['stash_bytes']} ledger "
        f"{ledger}")
    if not res["stash_bytes"] == ledger == RP0_LEDGER:
        raise AssertionError("[rp0] live stash bytes differ from the ledger")
    losses = [h[1] for h in res["history"]]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"[rp0] losses not finite and falling: {losses}")
    same = (rep_a["history"][0][1] == rep_b["history"][0][1]
            == res["history"][0][1]
            and all(torch.equal(p, q) for p, q in
                    zip(rep_a["model"].parameters(),
                        rep_b["model"].parameters())))
    if not same:
        raise AssertionError("[rp0] repeated step is not bit-identical")
    log("[rp0] repeated step: loss and params bit-identical")

    torch.cuda.reset_peak_memory_stats()
    off = train_gnn(g, cfg, n_epochs=2, seed=0, params=model0, fused="off")
    torch.cuda.synchronize()
    off_peak = torch.cuda.max_memory_allocated()
    for epoch, loss, ms in off["history"]:
        log(f"[rp0 fused=off] epoch {epoch}: loss {loss!r} {ms:.3f} ms")
    log(f"[rp0 fused=off] max_memory_allocated {off_peak} bytes")
    a, b = losses[:2], [h[1] for h in off["history"]]
    if not all(math.isclose(x, y, rel_tol=1e-3) for x, y in zip(a, b)):
        raise AssertionError(f"[rp0] fused losses {a} vs unfused {b}")
    if off["stash_bytes"] != res["stash_bytes"]:
        raise AssertionError(f"[rp0] unfused stash {off['stash_bytes']}")
    log(f"[rp0] fused=off within rtol 1e-3 of fused=auto: {a} vs {b}; "
        "stash bytes equal")
    profile_step(torch, g, cfg, res["model"])
    return {name: launches[name] for name in FUSED}


def planned(n_comp: int, n_rp: int, steps: int, probes: int = 0,
            stats: int = 0, moments: int = 0, quant_probes: int = 0) -> dict:
    """Launches of a run of the unfused (RP or declined) spelling: each
    training step and each autoprec probe quantizes, dequantizes, projects
    and recovers every compressed layer once (RP and IRP only for RP
    layers); an autoprec stats pass projects every RP layer once; a
    quant-health probe (the obs loop's or ``calibration="obs"``'s)
    projects, quantizes and dequantizes every compressed layer once, and
    recovers none; 8-bit AdamW quantizes its ``moments`` moment leaves once
    at init and after every step, and dequantizes them every step."""
    passes = steps + probes
    return {"quant_pack": (n_comp * (passes + quant_probes)
                           + moments * (steps + 1)),
            "dequant_unpack": (n_comp * (passes + quant_probes)
                               + moments * steps),
            "rp_project": n_rp * (passes + stats + quant_probes),
            "irp_project": n_rp * passes, "matmul_quant": 0,
            "dequant_matmul": 0, "flash_attention": 0}


def counted_run(torch, wrappers, want: dict, what: str, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after; raises unless they are ``want``.  Returns (result, counts, peak
    device bytes)."""
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    log(f"[{what}] launches {counts}")
    if counts != want:
        raise AssertionError(f"[{what}] launches {counts}, planned {want}")
    return res, counts, torch.cuda.max_memory_allocated()


def check_run(res: dict, ledger: list, what: str) -> list:
    """Finite, falling losses and the live stash equal to the ledger."""
    losses = [h[1] for h in res["history"]]
    for epoch, loss, ms in res["history"]:
        log(f"[{what}] epoch {epoch}: loss {loss!r} {ms:.3f} ms")
    log(f"[{what}] live stash bytes per layer {res['stash_bytes']} ledger "
        f"{ledger}")
    if res["stash_bytes"] != ledger:
        raise AssertionError(f"[{what}] live stash differs from the ledger")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"[{what}] losses not finite and falling: "
                             f"{losses}")
    return losses


def profile_allocate(torch, g, cfg, model) -> None:
    """Where autoprec's re-solve goes: host time of the stats pass, of the
    two-seed probe (two forward and backward passes) and of the whole
    allocate, each synchronized, then one profiled allocate (device busy
    time and idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.precision import AutoprecController
    from repro_torch.graph.analysis import collect_layer_stats
    from repro_torch.graph.models import device_graph

    dg = device_graph(g, cfg.arch, "cuda")
    ctrl = AutoprecController(dg, cfg, 2.0, 2, 0)
    ctrl.allocate(model)           # level tables computed and cached

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    stats, stats_ms = timed(lambda: collect_layer_stats(model, dg, cfg))
    _, probe_ms = timed(lambda: ctrl._probe_grad_sens(model, stats))
    _, alloc_ms = timed(lambda: ctrl.allocate(model))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(lambda: ctrl.allocate(model))
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[autoprec] re-solve: stats pass {stats_ms:.3f} ms, two-seed probe "
        f"{probe_ms:.3f} ms, whole allocate {alloc_ms:.3f} ms; profiled "
        f"allocate wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, idle "
        f"share {1 - busy / wall_ms:.3f}")
    log_profile(rows, 10)


def slice_table1(torch, g, cfg, model0, wrappers) -> dict:
    """Slice 4, the rest of the full-graph main path, at full width:
    autoprec on the arxiv slice (template ``cfg``: INT2, G=256, RP 8, VM),
    every layer at 8-bit VM, mixed widths, then Table 1's flickr rows and
    8-bit AdamW
    states (see the module docstring).  Returns the launch counts summed
    over the phase."""
    from repro_torch.core import autoprec
    from repro_torch.core.compressor import CompressionConfig
    from repro_torch.engine.compile import CompiledFull
    from repro_torch.graph.analysis import (collect_layer_stats,
                                            live_stash_bytes)
    from repro_torch.graph.data import flickr_like
    from repro_torch.graph.models import GNN, GNNConfig, device_graph
    from repro_torch.graph.train import activation_memory_report, train_gnn
    from repro_torch.optim import AdamWConfig

    total = collections.Counter()

    # 1. autoprec: allocate and recompile before epoch 0, re-solve at
    # epoch 2; stats passes twice, two probes each
    def autoprec_run():
        return train_gnn(g, cfg, n_epochs=4, seed=0, params=model0,
                         bit_budget=2.0, autoprec_refresh=2)

    want = planned(3, 3, steps=4, probes=4, stats=2)
    res, counts, peak = counted_run(torch, wrappers, want, "autoprec",
                                    autoprec_run)
    total.update(counts)
    bits, budget = res["bits_per_layer"], res["bit_budget_bytes"]
    per = res["cfg"].layer_compression()
    stats = collect_layer_stats(res["model"], device_graph(g, cfg.arch,
                                                           "cuda"), cfg)
    alloc_bytes = autoprec.total_stash_bytes(stats, per)
    log(f"[autoprec] bits_per_layer {bits} bit_budget_bytes {budget} "
        f"allocation bytes {alloc_bytes} val_acc {res['val_acc']} test_acc "
        f"{res['test_acc']} epochs/s {res['epochs_per_sec']} "
        f"max_memory_allocated {peak} bytes")
    if not all(b in autoprec.BIT_CHOICES for b in bits) or \
            alloc_bytes > budget:
        raise AssertionError(f"[autoprec] allocation {bits} ({alloc_bytes} "
                             f"bytes) outside BIT_CHOICES or the budget")
    report = activation_memory_report(g, res["cfg"])
    if res["stash_bytes"] != [r["compressed_bytes"]
                              for r in report["per_layer"]]:
        raise AssertionError("[autoprec] live stash differs from "
                             "activation_memory_report's per_layer")
    losses = check_run(res, live_stash_bytes(res["cfg"], g.n_feats,
                                             g.n_nodes), "autoprec")
    again = autoprec_run()
    if again["bits_per_layer"] != bits or \
            [h[1] for h in again["history"]] != losses:
        raise AssertionError("[autoprec] a repeated run differs: bits "
                             f"{again['bits_per_layer']}, losses "
                             f"{[h[1] for h in again['history']]}")
    log("[autoprec] repeated run: the same bits, bit-identical losses")
    profile_allocate(torch, g, cfg, res["model"])
    del res, again, stats

    # 2. every layer at 8 bits with the 256-level VM table
    cfg8 = cfg.with_layer_bits((8, 8, 8))
    res, counts, peak = counted_run(
        torch, wrappers, planned(3, 3, steps=2), "vm8",
        lambda: train_gnn(g, cfg8, n_epochs=2, seed=0, params=model0))
    total.update(counts)
    check_run(res, live_stash_bytes(cfg8, g.n_feats, g.n_nodes), "vm8")
    log(f"[vm8] val_acc {res['val_acc']} max_memory_allocated {peak} bytes")
    del res

    # 2b. mixed widths: a pinned mixed allocation trained, then the
    # refresh hook's recompile from the template's widths to it between
    # two steps of one CompiledFull (the next step stashes the new widths)
    mixed = cfg.with_layer_bits(MIXED_BITS)

    def mixed_runs():
        r = train_gnn(g, mixed, n_epochs=2, seed=0, params=model0)
        step = CompiledFull(device_graph(g, cfg.arch, "cuda"), cfg,
                            copy.deepcopy(model0).to("cuda"),
                            AdamWConfig(lr=5e-3, weight_decay=0.0))
        before = (float(step.step(0)), step.stash_bytes)
        step.recompile(mixed)
        return r, before, (float(step.step(1)), step.stash_bytes)

    (res, before, after), counts, peak = counted_run(
        torch, wrappers, planned(3, 3, steps=4), "mixed", mixed_runs)
    total.update(counts)
    check_run(res, live_stash_bytes(mixed, g.n_feats, g.n_nodes), "mixed")
    want = (live_stash_bytes(cfg, g.n_feats, g.n_nodes),
            live_stash_bytes(mixed, g.n_feats, g.n_nodes))
    log(f"[mixed] recompile {cfg.layer_compression()[0].bits}-bit -> "
        f"{MIXED_BITS}: losses {before[0]!r} -> {after[0]!r}, stash "
        f"{before[1]} -> {after[1]}")
    if (before[1], after[1]) != want or not all(
            math.isfinite(x) for x in (before[0], after[0])):
        raise AssertionError(f"[mixed] recompile: stash {before[1]} -> "
                             f"{after[1]}, ledgers {want[0]} -> {want[1]}")
    del res

    # 3. Table 1's flickr rows (benchmarks/table1_gnn.py: base_r = 2 * 500
    # // 8 = 125), SAGE 256-256, FLICKR_EPOCHS each from the same weights
    t0 = time.perf_counter()
    fg = flickr_like(scale=1.0)
    log(f"flickr-like: {fg.n_nodes} nodes, {fg.n_edges} edges, "
        f"{fg.n_feats} features, built in {time.perf_counter() - t0:.1f} s")
    if (fg.n_nodes, fg.n_feats, fg.num_classes) != (FLICKR_NODES, 500, 7):
        raise AssertionError(f"flickr-like is not {FLICKR_NODES} x 500, "
                             "7 classes")
    base_r = 2 * fg.n_feats // 8
    rows = (("FP32", None, None),
            ("INT2 (EXACT, per-row)", CompressionConfig(2, base_r, 8), None),
            ("INT2 block G/R=8", CompressionConfig(2, base_r * 8, 8), None),
            ("INT2+VM", CompressionConfig(2, base_r, 8, vm=True), None),
            ("INT2+VM, 8-bit AdamW states",
             CompressionConfig(2, base_r, 8, vm=True),
             AdamWConfig(lr=5e-3, weight_decay=0.0, state_bits=8)))
    fp32 = GNNConfig(arch="sage", hidden=(256, 256), n_classes=fg.num_classes)
    fmodel0 = GNN(fp32, fg.n_feats, generator=torch.Generator().manual_seed(0))
    for name, comp, opt in rows:
        fcfg = dataclasses.replace(fp32, compression=comp)
        n_comp = 0 if comp is None else 3
        # 8-bit AdamW: m and v of 3 weights and 3 biases
        want = planned(n_comp, n_comp, steps=FLICKR_EPOCHS,
                       moments=12 if opt is not None else 0)
        res, counts, peak = counted_run(
            torch, wrappers, want, f"table1 {name}",
            lambda: train_gnn(fg, fcfg, opt, n_epochs=FLICKR_EPOCHS, seed=0,
                              params=fmodel0))
        total.update(counts)
        report = activation_memory_report(fg, fcfg)
        live = live_stash_bytes(fcfg, fg.n_feats, fg.n_nodes)
        check_run(res, live, f"table1 {name}")
        m = report.get("compressed_bytes", report["fp32_bytes"])
        epoch_ms = [h[2] for h in res["history"]]
        log(f"[table1] flickr {name}: test_acc {res['test_acc']} epoch ms "
            f"{epoch_ms} M {m} bytes ({m / 1e6:.3f} MB, fp32 "
            f"{report['fp32_bytes']} bytes) live stash {sum(live)} bytes "
            f"max_memory_allocated {peak} bytes")
        del res
    return dict(total)


#: Phase 7's live stash a batch (activation_memory_report(...)["batched"]
#: ["per_layer"] of the RP-8 config at the halo-0 and halo-1 batches, and
#: of the rp_ratio-0 config at halo 0).
BATCH_LEDGER = [868_548, 1_059_204, 381_316]
HALO_BATCH_LEDGER = [5_413_316, 6_601_604, 2_376_580]
BATCH_RP0_LEDGER = [2_203_140, 3_728_388, 3_050_500]
BATCHED_EPOCHS = 5


def profile_update(torch, g, cfg, model, batches, grad_accum: int,
                   what: str) -> None:
    """Where one batched optimizer update goes: a partition step over the
    first ``grad_accum`` of ``batches`` (one update), profiled."""
    from repro_torch.engine.compile import compile_plan
    from repro_torch.engine.plan import ExecutionPlan
    from repro_torch.optim import AdamWConfig

    plan = ExecutionPlan.from_legacy(n_parts=grad_accum,
                                     grad_accum=grad_accum, shuffle=False)
    step = compile_plan(g, cfg, plan, model, AdamWConfig(lr=5e-3), "cuda",
                        batches=batches[:grad_accum])
    epochs = iter(range(2))
    profile_call(torch, lambda: step.step(next(epochs), range(grad_accum)),
                 f"batched update ({what})", top=12)


def batch_checks(res: dict, what: str, n_nodes: int, updates: int,
                 ledger: list, falling: bool = True) -> list:
    """The run's batch shape and update count, its live stash equal to the
    ledger, and finite (and, over more than two epochs, falling) losses."""
    got = (res["n_parts"], res["batch_nodes"], res["updates_per_epoch"])
    log(f"[{what}] n_parts, batch_nodes, updates_per_epoch {got}, "
        f"batch_edges {res['batch_edges']}, val_acc {res['val_acc']} "
        f"test_acc {res['test_acc']}")
    if got != (8, n_nodes, updates):
        raise AssertionError(f"[{what}] expected (8, {n_nodes}, {updates})")
    losses = [h[1] for h in res["history"]]
    if falling:
        return check_run(res, ledger, what)
    for epoch, loss, ms in res["history"]:
        log(f"[{what}] epoch {epoch}: loss {loss!r} {ms:.3f} ms")
    log(f"[{what}] live stash bytes per layer {res['stash_bytes']} ledger "
        f"{ledger}")
    if res["stash_bytes"] != ledger or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{what}] stash or losses: "
                             f"{res['stash_bytes']}, {losses}")
    return losses


def slice_batched(torch, g, cfg, cfg0, model0, wrappers, rp8_peak) -> dict:
    """Slice 10: the mini-batch partition engine through train_gnn_batched
    on phase 4's graph, config and weights (the module docstring lists
    (a)-(e)).  Returns the launch counts summed over the phase."""
    from repro_torch.core import autoprec
    from repro_torch.graph.analysis import collect_layer_stats
    from repro_torch.graph.models import device_graph
    from repro_torch.graph.sampling import make_subgraph_batches
    from repro_torch.graph.train import (activation_memory_report,
                                         train_gnn, train_gnn_batched)

    total = collections.Counter()

    def ledger(c, n_nodes):
        rep = activation_memory_report(g, c, n_parts=8, batch_nodes=n_nodes)
        return [r["compressed_bytes"] for r in rep["batched"]["per_layer"]]

    def same(a, b) -> bool:
        return (a["history"][0][1] == b["history"][0][1]
                and all(torch.equal(p, q) for p, q in
                        zip(a["model"].parameters(), b["model"].parameters())))

    # (a) one tightly padded batch is train_gnn, bit for bit
    (full, one), counts, _ = counted_run(
        torch, wrappers, planned(3, 3, steps=2), "batched identity",
        lambda: (train_gnn(g, cfg, n_epochs=1, seed=0, params=model0),
                 train_gnn_batched(g, cfg, 1, n_epochs=1, seed=0,
                                   params=model0, node_multiple=1,
                                   edge_multiple=1)))
    total.update(counts)
    if not same(full, one) or one["batch_nodes"] != N_NODES:
        raise AssertionError("[batched identity] n_parts=1 differs from "
                             "train_gnn")
    log(f"[batched identity] n_parts=1, tight padding: loss "
        f"{one['history'][0][1]!r} and params bit-identical to train_gnn")
    del full, one

    # (b) the examples recipe: 8 bfs parts, halo 0, BATCHED_EPOCHS epochs,
    # then two one-epoch repeats on the same batches
    t0 = time.perf_counter()
    batches = make_subgraph_batches(g, 8, method="bfs", seed=0)
    log(f"[batched] 8 bfs parts in {time.perf_counter() - t0:.1f} s: "
        f"{batches[0].n_nodes} x {batches[0].n_edges} padded, real nodes "
        f"{[b.n_real_nodes for b in batches]}")
    if (batches[0].n_nodes, batches[0].n_edges) != (BATCH_NODES,
                                                    BATCH_EDGES):
        raise AssertionError(f"[batched] expected {BATCH_NODES} x "
                             f"{BATCH_EDGES} padded")
    (res, rep_a, rep_b), counts, peak = counted_run(
        torch, wrappers, planned(3, 3, steps=8 * (BATCHED_EPOCHS + 2)),
        "batched", lambda: (
            train_gnn_batched(g, cfg, 8, n_epochs=BATCHED_EPOCHS, seed=0,
                              params=model0),
            train_gnn_batched(g, cfg, 8, n_epochs=1, seed=0, params=model0,
                              batches=batches),
            train_gnn_batched(g, cfg, 8, n_epochs=1, seed=0, params=model0,
                              batches=batches)))
    total.update(counts)
    want = ledger(cfg, BATCH_NODES)
    if want != BATCH_LEDGER:
        raise AssertionError(f"[batched] ledger {want}")
    batch_checks(res, "batched", BATCH_NODES, 8, want)
    if not (same(rep_a, rep_b)
            and rep_a["history"][0][1] == res["history"][0][1]):
        raise AssertionError("[batched] a repeated epoch is not "
                             "bit-identical")
    log(f"[batched] repeated epoch: loss and params bit-identical; "
        f"epochs/s {res['epochs_per_sec']} max_memory_allocated {peak} "
        f"bytes (phase 4: {rp8_peak})")
    profile_update(torch, g, cfg, res["model"], batches, 1, "halo 0")
    del res, rep_a, rep_b

    # (c) the README recipe: halo 1, grad_accum 2
    t0 = time.perf_counter()
    halo_batches = make_subgraph_batches(g, 8, method="bfs", halo=1, seed=0)
    log(f"[batched halo 1] 8 bfs parts in {time.perf_counter() - t0:.1f} s: "
        f"{halo_batches[0].n_nodes} x {halo_batches[0].n_edges} padded")
    res, counts, peak = counted_run(
        torch, wrappers, planned(3, 3, steps=16), "batched halo 1",
        lambda: train_gnn_batched(g, cfg, 8, n_epochs=2, seed=0,
                                  params=model0, grad_accum=2, halo=1,
                                  batches=halo_batches))
    total.update(counts)
    want = ledger(cfg, HALO_BATCH_NODES)
    if want != HALO_BATCH_LEDGER:
        raise AssertionError(f"[batched halo 1] ledger {want}")
    batch_checks(res, "batched halo 1", HALO_BATCH_NODES, 4, want,
                 falling=False)
    log(f"[batched halo 1] max_memory_allocated {peak} bytes")
    profile_update(torch, g, cfg, res["model"], halo_batches, 2, "halo 1")
    del res, halo_batches

    # (d) rp_ratio 0: fused="auto" (3 fused launches a batch step, nothing
    # unfused), then fused="off" from the same weights
    steps = 16
    fused_want = dict(planned(0, 0, steps), matmul_quant=3 * steps,
                      dequant_matmul=3 * steps)
    want = ledger(cfg0, BATCH_NODES)
    runs = {}
    for fused, plan in (("auto", fused_want), ("off", planned(3, 0, steps))):
        what = f"batched rp0 fused={fused}"
        runs[fused], counts, peak = counted_run(
            torch, wrappers, plan, what,
            lambda: train_gnn_batched(g, cfg0, 8, n_epochs=2, seed=0,
                                      params=model0, batches=batches,
                                      fused=fused))
        total.update(counts)
        batch_checks(runs[fused], what, BATCH_NODES, 8, want, falling=False)
        log(f"[{what}] max_memory_allocated {peak} bytes")
    a, b = ([h[1] for h in runs[k]["history"]] for k in ("auto", "off"))
    if want != BATCH_RP0_LEDGER or not all(
            math.isclose(x, y, rel_tol=1e-3) for x, y in zip(a, b)):
        raise AssertionError(f"[batched rp0] ledger {want}, fused losses "
                             f"{a} vs unfused {b}")
    log(f"[batched rp0] fused=off within rtol 1e-3 of fused=auto: {a} vs "
        f"{b}; stash bytes equal")
    del runs

    # (e) autoprec calibrated on batch 0 (the byte ceiling is per batch)
    def autoprec_run():
        return train_gnn_batched(g, cfg, 8, n_epochs=4, seed=0,
                                 params=model0, batches=batches,
                                 bit_budget=2.0, autoprec_refresh=2)

    res, counts, peak = counted_run(
        torch, wrappers, planned(3, 3, steps=32, probes=4, stats=2),
        "batched autoprec", autoprec_run)
    total.update(counts)
    bits, budget = res["bits_per_layer"], res["bit_budget_bytes"]
    stats = collect_layer_stats(res["model"], device_graph(
        batches[0], cfg.arch, "cuda"), cfg)
    alloc_bytes = autoprec.total_stash_bytes(stats,
                                             res["cfg"].layer_compression())
    log(f"[batched autoprec] bits_per_layer {bits} bit_budget_bytes {budget} "
        f"allocation bytes {alloc_bytes} max_memory_allocated {peak} bytes")
    if not all(b in autoprec.BIT_CHOICES for b in bits) or \
            alloc_bytes > budget:
        raise AssertionError(f"[batched autoprec] allocation {bits} "
                             f"({alloc_bytes} bytes) outside BIT_CHOICES "
                             "or the budget")
    losses = batch_checks(res, "batched autoprec", BATCH_NODES, 8,
                          ledger(res["cfg"], BATCH_NODES))
    again = autoprec_run()
    if again["bits_per_layer"] != bits or \
            [h[1] for h in again["history"]] != losses:
        raise AssertionError("[batched autoprec] a repeated run differs")
    log("[batched autoprec] repeated run: the same bits, bit-identical "
        "losses")
    return dict(total)


FLASH_SHAPE = (80, 1000, 128)    # slice 3 prefill: 4 requests x 20 heads


def check_flash(torch, fa, ref, flush, gen, shape=FLASH_SHAPE,
                prefix: str = "") -> dict:
    """flash_attention against its plain version: at the serving prefill
    ``shape``, causal, bf16 (atol 1e-3, rtol 2**-7: an output may round to the
    other neighbouring bf16) and float32 (within 3e-5), in both scale
    orders, and at ragged Sq != Skv with q_offset / kv_len.  At the bf16
    prefill shape also two calls bit-identical, and at most 1 % of the
    outputs not bit-equal to the plain version's (mismatch_share).  The
    control for that limit: the same attention with P rounded to bf16 once
    (what a kernel without the split computes) must exceed it
    (single_p_mismatch_share).  Timed at the prefill shape (q scaled first,
    as the model calls it) beside the plain version, one float32
    F.scaled_dot_product_attention (library_ms: the same function) and, for
    bf16, one bf16 SDPA (sdpa_bf16_ms, context only: it rounds P to bf16).
    The bound counts the function's 4 * Dh flops a kept pair (Q K^T and
    P V), at the bf16 tensor-core peak for bf16 inputs; the kernel's second
    P V pass for the split P is its own cost, not the function's.
    f32_bound_ms is the float32 SIMT bound (67 TFLOP/s), which the float32
    kernel keeps.  With a ``prefix`` (another model's prefill shape) only
    the bf16 prefill case runs, its row tagged ``prefix + "prefill bf16"``."""
    import torch.nn.functional as F

    def single_bf16_p(q, k, v, scale_q):
        """Causal attention as the kernel computes it, but with P = exp(s - m)
        rounded to bf16 once before P V (float32 sums, l unrounded)."""
        sc = torch.tensor(q.shape[-1] ** -0.5, dtype=torch.float32,
                          device=q.device)
        qf, kf = q.float(), k.float()
        sf = (qf * sc) @ kf.mT if scale_q else (qf @ kf.mT) * sc
        pos = torch.arange(q.shape[-2], device=q.device)
        sf = sf.masked_fill(pos[None, :] > pos[:, None], ref.NEG_INF)
        p = torch.exp(sf - sf.amax(-1, keepdim=True))
        out = (p.to(torch.bfloat16).float() @ v.float()) / p.sum(-1, True)
        return out.to(torch.bfloat16)

    rows = {}
    bh, s, dh = shape
    # (atol, rtol): float32 within 3e-5; a bf16 output within one bf16 ulp
    # of the plain version's (2**-7 relative), 1e-3 absolute near zero
    f32_tol, bf16_tol = (3e-5, 3e-5), (1e-3, 2.0 ** -7)
    cases = [("prefill bf16", shape, s, torch.bfloat16, True, 0, None,
              bf16_tol),
             ("prefill f32", shape, s, torch.float32, True, 0, None,
              f32_tol),
             ("ragged f32", (6, 70, 128), 200, torch.float32, True, 130,
              None, f32_tol),
             ("ragged kv_len bf16", (6, 77, 128), 200, torch.bfloat16, True,
              60, 137, bf16_tol),
             ("full kv_len f32", (6, 70, 64), 200, torch.float32, False, 0,
              131, f32_tol)]
    if prefix:
        cases = [(prefix + c[0], *c[1:]) for c in cases[:1]]
    for tag, (b, sq, d), skv, dt, causal, q_off, kv_len, tol in cases:
        errs, shares, ctrl = [], [], []  # this case's: each row its own
        q = torch.randn((b, sq, d), device="cuda", generator=gen).to(dt)
        k = torch.randn((b, skv, d), device="cuda", generator=gen).to(dt)
        v = torch.randn((b, skv, d), device="cuda", generator=gen).to(dt)
        for scale_q in (True, False):
            kw = dict(causal=causal, q_offset=q_off, kv_len=kv_len,
                      scale_q=scale_q)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=tol[0], rtol=tol[1])
            errs.append(err)
            log(f"flash_attention {tag} {b}x{sq}x{d} skv={skv} causal="
                f"{causal} q_offset={q_off} kv_len={kv_len} scale_q="
                f"{scale_q}: max abs err {err} (atol, rtol {tol})")
            if dt == torch.bfloat16:
                shares.append(float((got != want).float().mean()))
                log(f"  share of bf16 outputs not bit-equal to the plain "
                    f"version's: {shares[-1]}")
            if tag == prefix + "prefill bf16":
                if not torch.equal(got, fa.flash_attention(q, k, v, **kw)):
                    raise AssertionError(f"flash_attention {tag}: two calls "
                                         "differ")
                if shares[-1] > 0.01:
                    raise AssertionError(f"flash_attention {tag}: "
                                         f"{shares[-1]} of the outputs not "
                                         "bit-equal")
                ctrl.append(float((single_bf16_p(q, k, v, scale_q) != want)
                                  .float().mean()))
                log(f"  control, P rounded to bf16 once: {ctrl[-1]} not "
                    "bit-equal")
                if ctrl[-1] <= 0.01:
                    raise AssertionError(f"flash_attention {tag}: a single "
                                         f"bf16 P gives {ctrl[-1]} <= 0.01, "
                                         "so the limit does not tell it")
        if "prefill" in tag:
            kern = lambda: fa.flash_attention(q, k, v, causal=True,
                                              scale_q=True)
            plain = lambda: ref.flash_attention(q, k, v, causal=True,
                                                scale_q=True)
            q4, k4, v4 = (t.float()[None] for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                         is_causal=True)
            pairs = s * (s + 1) // 2            # causal (query, key) pairs
            nbytes = 4 * bh * s * dh * q.element_size()
            f32_bnd = bound(nbytes, 4 * bh * dh * pairs)
            row = dict(ms=time_ms(torch, kern, flush),
                       plain_ms=time_ms(torch, plain, flush),
                       library_ms=time_ms(torch, lib, flush),
                       bound_ms=f32_bnd[0], bound_by=f32_bnd[1],
                       max_abs_err=max(errs), flops=4 * bh * dh * pairs,
                       bytes=nbytes)
            if dt == torch.bfloat16:
                lib_bf16 = lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True)
                bnd = bound(nbytes, 4 * bh * dh * pairs, PEAK_BF16_OPS_PER_S)
                row.update(bound_ms=bnd[0], bound_by=bnd[1],
                           f32_bound_ms=f32_bnd[0],
                           mismatch_share=max(shares),
                           single_p_mismatch_share=min(ctrl),
                           sdpa_bf16_ms=time_ms(torch, lib_bf16, flush))
            log(f"flash_attention {tag}: {row}")
            rows[("flash_attention", tag)] = row
        del q, k, v
    return rows


#: slice 3's KV cache at qwen1.5-4b: 20 KV heads x 128 = 2560 elements a
#: token, 40 blocks of G=64 at 4 bits; 4 slots x 65 pages x 16 tokens.
KV_G, KV_BITS, KV_NBT = 64, 4, 40
KV_PREFILL_TOKENS = 4 * 1008         # a group's page-aligned prompt rows
KV_PAGE_TOKENS = 2 * 4 * 16          # one decode read: K and V of a page
                                     # of each of 4 slots


def check_kv_quant(torch, qk, ref, flush, gen, nbt: int = KV_NBT,
                   prefix: str = "") -> dict:
    """The KV cache's use of the quant kernels at ``nbt`` blocks a token:
    quant_pack with one seed per token (counters restarting per token) at
    a prefill group's and a decode step's rows, bit-equal to the plain
    version; dequant_unpack of a page of K and V of 4 slots, bit-equal to
    the plain version.  Timed; rows tagged with ``prefix``."""
    from repro_torch.engine.seeds import kv_seed

    rows = {}
    for tag, n_tok in (("kv prefill", KV_PREFILL_TOKENS), ("kv decode", 4)):
        x = torch.randn((n_tok * nbt, KV_G), device="cuda",
                        generator=gen) * 1.3
        seeds = kv_seed(torch.arange(n_tok, device="cuda") % 1008,
                        torch.arange(n_tok, device="cuda") // 1008, 7, 1)
        got = qk.quant_pack(x, KV_BITS, seeds, rows_per_seed=nbt)
        want = ref.quantize_packed(x, KV_BITS, seeds, rows_per_seed=nbt)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"seeded quant_pack {tag}: not bit-equal")
        n = n_tok * nbt
        nbytes = n * KV_G * 4 + n * KV_G * KV_BITS // 8 + 8 * n + 4 * n_tok
        bnd = bound(nbytes, 18 * n * KV_G)
        row = dict(ms=time_ms(torch, lambda: qk.quant_pack(
                       x, KV_BITS, seeds, rows_per_seed=nbt), flush),
                   plain_ms=time_ms(torch, lambda: ref.quantize_packed(
                       x, KV_BITS, seeds, rows_per_seed=nbt), flush),
                   bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=0.0,
                   library_ms=None, bytes=nbytes)
        log(f"quant_pack (seeded) {prefix}{tag} {n}x{KV_G}: bit-equal; {row}")
        rows[("quant_pack", f"{prefix}{tag} {n}x{KV_G}")] = row
    n = KV_PAGE_TOKENS * nbt
    x = torch.randn((n, KV_G), device="cuda", generator=gen)
    pk, zk, rk = qk.quant_pack(x, KV_BITS, 5)
    got = qk.dequant_unpack(pk, zk, rk, KV_BITS, KV_G)
    want = ref.dequantize_packed(pk, zk, rk, KV_BITS, KV_G)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > 1e-6:
        raise AssertionError(f"dequant_unpack kv page: max abs err {err}")
    nbytes = n * KV_G * 4 + n * KV_G * KV_BITS // 8 + 8 * n
    bnd = bound(nbytes, 4 * n * KV_G)
    row = dict(ms=time_ms(torch, lambda: qk.dequant_unpack(
                   pk, zk, rk, KV_BITS, KV_G), flush),
               plain_ms=time_ms(torch, lambda: ref.dequantize_packed(
                   pk, zk, rk, KV_BITS, KV_G), flush),
               bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err,
               library_ms=None, bytes=nbytes)
    log(f"dequant_unpack {prefix}kv page {n}x{KV_G}: max abs err {err}; "
        f"{row}")
    rows[("dequant_unpack", f"{prefix}kv page {n}x{KV_G}")] = row
    return rows


SERVE_ARGV = ["--arch", "qwen1.5-4b", "--requests", "8", "--max-batch", "4",
              "--prompt-len", "1000", "--gen-len", "32", "--kv-bits", "4",
              "--kv-group", "64", "--page-tokens", "16", "--mode",
              "continuous", "--kv-policy", "device", "--device", "cuda"]
#: A slot's page table: ceil((1000 + 32 - 1) / 16) pages.
SERVE_PAGES_PER_SLOT = 65
#: Phase 8's depth: qwen1.5-4b's 40 layers cut to 20, to keep the whole
#: script within 900 s beside phase 14.
SERVE_LAYERS = 20
#: Launches over one serving run: 2 prefill groups x SERVE_LAYERS layers
#: of flash; quant_pack once per layer and stream for each group's prompt
#: and each of the 62 decode steps (2 groups x 31); dequant_unpack once per
#: layer and page of the table (K and V together: the page-by-page read)
#: each step.
SERVE_LAUNCHES = {"flash_attention": 2 * SERVE_LAYERS,
                  "quant_pack": (2 + 62) * 2 * SERVE_LAYERS,
                  "dequant_unpack": 62 * SERVE_LAYERS * SERVE_PAGES_PER_SLOT}
#: SERVE_LAYERS x 260 pages x 51,200 bytes (4-bit words + zero/range, K
#: and V): 266,240,000 at 20 layers (532,480,000 at 40)
SERVE_POOL_BYTES = SERVE_LAYERS * 260 * 51_200


@contextlib.contextmanager
def window_read(dequant):
    """Inside: the serving engine's decode reads each slot's pages as one
    float32 window, as the port did before the page-by-page read: every
    page of the table gathered (null pages as zeros) and dequantized at
    once by ``dequant`` (the kernel: one launch a layer and stream), then
    ``decode_attend`` over the window.  The engine's ``make_page_fetch``
    and ``decode_attend_paged`` are swapped for it and restored after."""
    from repro_torch.models import attention as attn
    from repro_torch.serving import kvcache

    def fetch(pool_l, layout, table):
        return pool_l, layout, table

    def attend(q, pos, n_chunks, fetched, *, n_kv_heads, out_dtype):
        pool_l, layout, table = fetched
        b, maxp = table.shape
        kv = []
        for name in ("k", "v"):
            pk, pz, pr = (kvcache._gather_pages(pool_l[f"{name}_{f}"], table,
                                                layout.n_pages)
                          for f in ("packed", "zero", "rng"))
            blocks = dequant(pk.reshape(-1, layout.words_per_block),
                             pz.reshape(-1), pr.reshape(-1), layout.bits,
                             layout.group_size)
            kv.append(blocks.reshape(b, maxp * layout.page_tokens,
                                     layout.n_kv_heads, layout.d_head))
        return attn.decode_attend(q, kv[0], kv[1], pos, out_dtype=out_dtype)

    saved = kvcache.make_page_fetch, attn.decode_attend_paged
    kvcache.make_page_fetch, attn.decode_attend_paged = fetch, attend
    try:
        yield
    finally:
        kvcache.make_page_fetch, attn.decode_attend_paged = saved


def admit_group(engine, requests):
    """Seat the first ``max_batch`` requests as one prefill group of a
    fresh state; returns (state, host page table, prefill ms)."""
    import torch

    for r in requests[:engine.max_batch]:
        engine.sched.submit(r)
    group = engine.sched.admit()
    table = np.full((engine.max_batch, engine.max_pages_per_slot),
                    engine.layout.null_page, np.int32)
    state = engine._init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = engine._admit_group(group, state, table)
    torch.cuda.synchronize()
    return state, table, (time.perf_counter() - t0) * 1e3


def paged_against_window(torch, engine, page_table, state, ref) -> tuple:
    """One decode step of every seated slot through the page-by-page read,
    then the same step from the same pool and state through
    ``decode_attend`` over the window dequantized by the plain version
    (``window_read(ref.dequantize_packed)``).  The engine must collect
    logits; returns (max abs difference of the step's logits, their
    largest magnitude, argmax equal); the pool and state are left as the
    window step leaves them."""
    rows = torch.arange(engine.max_batch, device="cuda")
    col = state["gen"].to(torch.int64)
    pool0 = {k: v.clone() for k, v in engine.pool.items()}
    state0 = {k: v.clone() for k, v in state.items()}
    paged = engine._step(page_table, state)["logits"][rows, col].clone()
    for k, v in engine.pool.items():
        v.copy_(pool0[k])
    with window_read(ref.dequantize_packed):
        window = engine._step(page_table, state0)["logits"][rows, col]
    torch.cuda.synchronize()
    if not (torch.isfinite(paged).all() and torch.isfinite(window).all()):
        raise AssertionError("[serve] non-finite decode logits")
    return (float((paged - window).abs().max()), float(window.abs().max()),
            bool(torch.equal(paged.argmax(-1), window.argmax(-1))))


def timed(torch, fn):
    """(``fn()``, host ms) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profiled(torch, fn, what: str, top: int = 12):
    """``fn()`` under torch.profiler: logs its wall time, device busy time,
    idle share and device time by kernel; returns (``fn()``, wall ms,
    busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, wall_ms = timed(torch, fn)
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count,
             e.key) for e in prof.key_averages()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profiled {what}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
    log_profile(rows, top)
    return out, wall_ms, busy


def profile_serve(torch, engine, requests, qk, ref) -> dict:
    """One admission group's prefill and single decode steps of a fresh
    engine (collecting logits): host time (synchronized), the decode step
    through the page-by-page read and through the window read it replaced
    (``window_read`` with the kernel) in turns, one step's logits through
    both reads (``paged_against_window``), then one profiled prefill and
    one profiled decode step (device time by kernel, idle share)."""
    out = {}
    state, table, out["prefill_ms"] = admit_group(engine, requests)
    page_table = torch.as_tensor(table, device=engine.device)
    steps = {"paged": [], "window": []}
    for read in ("paged", "window", "window", "paged"):
        for _ in range(3):
            with (window_read(qk.dequant_unpack) if read == "window"
                  else contextlib.nullcontext()):
                state, ms = timed(torch,
                                  lambda: engine._step(page_table, state))
            engine.sched.tick()
            steps[read].append(ms)
    out["decode_ms"] = steps
    err, scale, same = paged_against_window(torch, engine, page_table, state,
                                            ref)
    engine.sched.tick()
    log(f"[serve] {SERVE_LAYERS} layers: a decode step's logits through the "
        f"paged read "
        f"against decode_attend over the plain-dequantized window: max abs "
        f"err {err} (logits up to {scale}); argmax equal {same}")
    profiled(torch, lambda: engine._step(page_table, state), "decode step")
    for si in range(engine.max_batch):
        engine.sched.complete(si)
    for r in requests[:engine.max_batch]:
        engine.sched.submit(r)
    group = engine.sched.admit()
    profiled(torch,
             lambda: engine._admit_group(group, engine._init_state(), table),
             "prefill (4 x 1000 tokens)")
    log(f"[serve] unprofiled: prefill of a 4 x 1000 group "
        f"{out['prefill_ms']:.3f} ms; decode steps, paged read "
        f"{steps['paged']} ms, window read {steps['window']} ms")
    return out


def slice_serve(torch, wrappers, fa, qk, ref) -> dict:
    """Slice 3: serving full-width qwen1.5-4b through the launcher's engine
    (see the module docstring).  Returns the serving run's launch counts."""
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import pool_nbytes

    args = serve.parser().parse_args(SERVE_ARGV)
    t0 = time.perf_counter()
    model = Model(dataclasses.replace(get("qwen1.5-4b"), act_mode="none",
                                      n_layers=SERVE_LAYERS))
    torch.cuda.synchronize()
    log(f"[serve] qwen1.5-4b at {SERVE_LAYERS} of its 40 layers: "
        f"{model.cfg.param_count()} parameters (ArchConfig.param_count), "
        f"{sum(p.numel() for p in model.parameters())} in the model, built "
        f"in {time.perf_counter() - t0:.1f} s")

    # the counted and timed run is the launcher's: no logits collected;
    # plain attention must not run on the card during it
    engine, requests = serve.build_engine(args, model)
    pool_bytes = pool_nbytes(engine.pool)
    plain_calls = [0]
    with plain_attention_on_card(ref, plain_calls):
        for w in wrappers:
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = engine.run(requests)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()
    serve.report(args, engine, out)
    log(f"[serve] launches over the run: {launches}; plain attention calls "
        f"on the card: {plain_calls[0]}")
    for name, n in launches.items():
        if n != SERVE_LAUNCHES.get(name, 0):
            raise AssertionError(f"[serve] {name}: {n} launches, expected "
                                 f"{SERVE_LAUNCHES.get(name, 0)}")
    if plain_calls[0]:
        raise AssertionError("[serve] plain attention ran on the card")
    done = [r for r in out["results"] if r.status == "done"]
    if len(done) != 8 or any(r.tokens.shape != (32,) for r in done):
        raise AssertionError(f"[serve] {len(done)}/8 requests served")
    log(f"[serve] pool bytes {pool_bytes} layout {engine.layout.pool_bytes} "
        f"f32 {engine.layout.f32_pool_bytes}; pages {engine.layout.n_pages}")
    if not pool_bytes == engine.layout.pool_bytes == SERVE_POOL_BYTES:
        raise AssertionError("[serve] pool bytes differ from the layout")
    log(f"[serve] TTFT mean {out['ttft_mean_ms']!r} ms, TPOT mean "
        f"{out['tpot_mean_ms']!r} ms, {out['tokens_per_sec']!r} tokens/s, "
        f"p50 {out['p50_latency_ms']!r} ms, p99 {out['p99_latency_ms']!r} "
        f"ms, wall {out['wall_s']!r} s, {out['decode_steps']} decode steps, "
        f"max_memory_allocated {peak} bytes")
    log(f"[serve] first request's tokens {done[0].tokens.tolist()}")
    del engine

    # the same requests twice more, collecting logits: identical tokens and
    # logits, and the tokens of the run above
    runs = []
    for _ in range(2):
        eng, _ = serve.build_engine(args, model, collect_logits=True)
        runs.append(eng.run(requests))
        del eng
    first, again = runs
    for res in (first, again):
        for a, b in zip(out["results"], res["results"]):
            if not np.array_equal(a.tokens, b.tokens):
                raise AssertionError(f"[serve] request {a.rid}: tokens "
                                     "differ from the uncollected run")
        if not all(np.isfinite(res["logits"][r.rid]).all() for r in done):
            raise AssertionError("[serve] non-finite logits")
    if not all(np.array_equal(first["logits"][r.rid], again["logits"][r.rid])
               for r in done):
        raise AssertionError("[serve] a repeated run's logits differ")
    log("[serve] repeated runs: tokens identical to the timed run, logits "
        "identical to each other and finite")
    del out, first, again, runs

    profile_serve(torch, serve.build_engine(args, model,
                                            collect_logits=True)[0],
                  requests, qk, ref)
    del model
    torch.cuda.empty_cache()

    # 2 layers of full width: the prefill logits with the kernel against
    # the plain attention, on the card, from the same weights and prompts
    cfg2 = dataclasses.replace(get("qwen1.5-4b"), n_layers=2,
                               act_mode="none")
    two = Model(cfg2, generator=torch.Generator("cuda").manual_seed(1))
    prompts = torch.as_tensor(np.stack([r.prompt for r in requests[:4]]),
                              device="cuda")
    with_kernel, _ = two.prefill(prompts)
    two.impl = "torch"
    with_plain, _ = two.prefill(prompts)
    torch.cuda.synchronize()
    err = float((with_kernel - with_plain).abs().max())
    scale = float(with_plain.abs().max())
    log(f"[serve] 2 layers: prefill logits kernel vs plain attention: max "
        f"abs err {err} (logits up to {scale}); argmax equal "
        f"{torch.equal(with_kernel.argmax(-1), with_plain.argmax(-1))}")
    # bf16 activations: an attention output may round to the neighbouring
    # bf16 value (2**-8 relative), which the rest of the layer carries on
    if err > 0.1:
        raise AssertionError(f"[serve] 2-layer logits differ by {err}")
    # and a decode step's logits through the paged read against
    # decode_attend over the same pages laid end to end (plain-dequantized):
    # the same bf16 band (the two sum the softmax in other orders)
    two.impl = "auto"
    engine2 = serve.build_engine(args, two, collect_logits=True)[0]
    state, table, _ = admit_group(engine2, requests)
    err, scale, same = paged_against_window(
        torch, engine2, torch.as_tensor(table, device="cuda"), state, ref)
    log(f"[serve] 2 layers: a decode step's logits through the paged read "
        f"against the plain-dequantized window: max abs err {err} (logits "
        f"up to {scale}); argmax equal {same}")
    if err > 0.1:
        raise AssertionError(f"[serve] 2-layer decode logits differ by {err}")
    del two, engine2
    return launches


# --------------------------------------------------- phase 9: the offload
#: The stash placements phase 9 runs, None being the per-tensor stash.
PLACEMENTS = (None, "device", "host", "pinned-paged")


def copy_overlap(trace_path: str) -> dict:
    """From a chrome trace of torch.profiler: per CUDA stream that ran host
    copies, their count, time, and the part of that time during which a
    kernel ran on another stream (the copy time the compute hides)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]

    def spans(cat):
        return [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"),
                 e.get("name", "")) for e in events
                if e.get("cat") == cat and "dur" in e]

    kernels = spans("kernel")
    out = {}
    for stream in {s for _, _, s, name in spans("gpu_memcpy")
                   if "DtoD" not in name}:
        mine = [(a, b) for a, b, s, name in spans("gpu_memcpy")
                if s == stream and "DtoD" not in name]
        # the union of the other streams' kernel spans
        busy = []
        for a, b in sorted((a, b) for a, b, s, _ in kernels if s != stream):
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        total = sum(b - a for a, b in mine)
        hidden = sum(max(0.0, min(b, y) - max(a, x))
                     for a, b in mine for x, y in busy)
        out[stream] = {"copies": len(mine), "copy_ms": total / 1e3,
                       "hidden_ms": hidden / 1e3,
                       "hidden_share": hidden / total if total else 0.0}
    return out


def offload_probe(torch, graph, cfg, model, policy, fused: str, what: str,
                  profile_it: bool = False) -> int:
    """One forward and backward of ``cfg`` on ``graph`` through a fresh
    ArenaStore at ``policy`` (None: the per-tensor stash): host_store_bytes
    must be the plan's bytes after the forward (0 for None and "device")
    and 0 after the backward; logs the peak the step adds to what was
    allocated before it.  Returns the step's measured residual bytes, the
    reference offload benchmark's measure: the device bytes allocated with
    the forward's graph (through the loss) alive, less those allocated once
    the backward has run and its outputs are released.  With
    ``profile_it``, a second step runs under torch.profiler and each
    stream's host copies are read against the other streams' kernels."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.compile import masked_nll
    from repro_torch.engine.forward import stash_gnn_forward
    from repro_torch.offload.engine import ArenaStore, host_store_bytes
    from repro_torch.offload.gnn import plan_gnn_stashes

    n_nodes, in_dim = graph.features.shape
    plan = plan_gnn_stashes(cfg, in_dim, n_nodes)
    store = None if policy is None else ArenaStore(plan, policy, "cuda")

    def step(seed):
        logits = stash_gnn_forward(model, graph, cfg, seed, fused, store)
        loss = masked_nll(logits, graph.labels, graph.train_mask)
        torch.cuda.synchronize()
        after = host_store_bytes()
        with_graph = torch.cuda.memory_allocated()
        grads = torch.autograd.grad(loss, model.flat_params())
        torch.cuda.synchronize()
        del logits, loss, grads
        released = torch.cuda.memory_allocated()
        return after, host_store_bytes(), with_graph - released

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fwd, bwd, residual = step(0)
    first_ms = (time.perf_counter() - t0) * 1e3
    want = 0 if policy in (None, "device") else plan.total_bytes
    log(f"[{what}] probe step: host_store_bytes {fwd} after the forward "
        f"(planned {plan.total_bytes}), {bwd} after the backward; measured "
        f"residual {residual} bytes; peak "
        f"{torch.cuda.max_memory_allocated() - base} bytes above the {base} "
        f"allocated before it; {first_ms:.3f} ms (a first step: host "
        "arenas allocated)")
    if (fwd, bwd) != (want, 0):
        raise AssertionError(f"[{what}] host store {fwd} / {bwd}, expected "
                             f"{want} / 0")
    if not profile_it:
        return residual
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(1)
            wall = (time.perf_counter() - t0) * 1e3
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        streams = copy_overlap(path)
    busy = sum(getattr(e, "self_device_time_total", 0.0) / 1e3
               for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA)
    log(f"[{what}] profiled step: wall {wall:.3f} ms, device time summed "
        f"over streams {busy:.3f} ms; host copies by stream {streams}")
    if not streams:
        raise AssertionError(f"[{what}] the profile shows no host copy")
    return residual


def check_ordering(residual: dict, what: str) -> None:
    """The reference offload benchmark's ``ordering_ok``: measured residual
    bytes ``pinned-paged <= device <= None`` (host arena <= device arena <=
    the per-tensor stash)."""
    order = [residual[p] for p in ("pinned-paged", "device", None)]
    log(f"[{what}] measured residual bytes: pinned-paged {order[0]}, device "
        f"{order[1]}, None {order[2]}")
    if not order[0] <= order[1] <= order[2]:
        raise AssertionError(f"[{what}] residual ordering pinned-paged <= "
                             f"device <= None fails: {order}")


def offload_runs(torch, wrappers, what: str, want: dict, policies,
                 run) -> dict:
    """``run(policy)`` for each placement, counted (launches as ``want``
    each) with the peak reset before it.  Logs each run's epochs, peak and
    the arena's gauges; asserts every run bit-identical to the first
    (losses and params), the readers' device-resident stash within the
    ledger's window, every packed view aligned, and the stash bytes equal.
    Returns the launches summed over the runs."""
    total = collections.Counter()
    runs = {}
    for policy in policies:
        tag = f"{what} offload={policy}"
        res, counts, peak = counted_run(torch, wrappers, want, tag,
                                        lambda: run(policy))
        total.update(counts)
        runs[policy] = res
        ms = [round(h[2], 3) for h in res["history"]]
        log(f"[{tag}] losses {[h[1] for h in res['history']]} epoch ms {ms} "
            f"max_memory_allocated {peak} bytes stash {res['stash_bytes']}")
        if policy is None:
            continue
        a = res["arena"]
        log(f"[{tag}] arena {a}")
        if not (a["resident_peak_bytes"] <= a["device_resident_bytes"]
                and a["misaligned_views"] == 0
                and a["planned_bytes"] == sum(res["stash_bytes"])):
            raise AssertionError(f"[{tag}] arena gauges {a}")
    first = runs[policies[0]]
    for policy, res in runs.items():
        same = ([h[1] for h in res["history"]]
                == [h[1] for h in first["history"]]
                and all(torch.equal(p, q) for p, q in zip(
                    res["model"].parameters(), first["model"].parameters())))
        if not same:
            raise AssertionError(f"[{what}] offload={policy} is not "
                                 f"bit-identical to offload={policies[0]}")
        if res["stash_bytes"] != first["stash_bytes"]:
            raise AssertionError(f"[{what}] offload={policy} stash bytes")
    log(f"[{what}] placements {list(policies)}: losses and params "
        "bit-identical")
    return dict(total)


def slice_offload(torch, g, cfg, cfg0, model0, wrappers) -> dict:
    """Phase 9 (a)-(d): the stash arena and offload engine on phase 4's
    graph and weights (see the module docstring).  Returns the launch
    counts summed over the counted runs."""
    from repro_torch.graph.models import GNNConfig, device_graph
    from repro_torch.graph.sampling import make_subgraph_batches
    from repro_torch.graph.train import train_gnn, train_gnn_batched

    total = collections.Counter()
    dg = device_graph(g, cfg.arch, "cuda")
    model = copy.deepcopy(model0).to("cuda")

    # (a) the RP-8 config, 3 epochs under every placement
    total.update(offload_runs(
        torch, wrappers, "offload rp8", planned(3, 3, steps=3), PLACEMENTS,
        lambda p: train_gnn(g, cfg, n_epochs=3, seed=0, params=model0,
                            offload=p)))
    check_ordering({policy: offload_probe(
        torch, dg, cfg, model, policy, "auto", f"offload rp8 {policy}",
        policy in ("host", "pinned-paged")) for policy in PLACEMENTS},
        "offload rp8")

    # (b) rp_ratio 0, fused="auto": the fused backward reads the packed
    # words the reader hands back
    steps = 2
    fused_want = dict(planned(0, 0, steps), matmul_quant=3 * steps,
                      dequant_matmul=3 * steps)
    total.update(offload_runs(
        torch, wrappers, "offload rp0 auto", fused_want, PLACEMENTS,
        lambda p: train_gnn(g, cfg0, n_epochs=steps, seed=0, params=model0,
                            fused="auto", offload=p)))
    check_ordering({policy: offload_probe(
        torch, dg, cfg0, model, policy, "auto", f"offload rp0 {policy}",
        policy == "pinned-paged") for policy in PLACEMENTS}, "offload rp0")

    # (c) uncompressed: every layer's raw f32 input in the arena; the
    # host window (layers 1-2) is visibly smaller than the pool
    raw = GNNConfig(arch="sage", hidden=(256, 256), n_classes=40,
                    compression=None)
    total.update(offload_runs(
        torch, wrappers, "offload raw", planned(0, 0, 2),
        (None, "device", "pinned-paged"),
        lambda p: train_gnn(g, raw, n_epochs=2, seed=0, params=model0,
                            offload=p)))
    check_ordering({policy: offload_probe(
        torch, dg, raw, model, policy, "auto", f"offload raw {policy}",
        policy == "pinned-paged") for policy in (None, "device",
                                                 "pinned-paged")},
        "offload raw")
    del dg

    # (d) the mini-batch engine, halo 0, 8 parts
    batches = make_subgraph_batches(g, 8, method="bfs", seed=0)
    total.update(offload_runs(
        torch, wrappers, "offload batched", planned(3, 3, steps=16),
        (None, "device", "host"),
        lambda p: train_gnn_batched(g, cfg, 8, n_epochs=2, seed=0,
                                    params=model0, batches=batches,
                                    offload=p)))
    batch0 = device_graph(batches[0], cfg.arch, "cuda")
    for policy in (None, "device", "host"):
        offload_probe(torch, batch0, cfg, model, policy, "auto",
                      f"offload batched {policy}", policy == "host")
    return dict(total)


# ---------------------------------------------------- phase 10: the mesh
MESH_EPOCHS = 3
#: Seconds phase 10's two ranks may take in all, start-up included, before
#: they are killed and the phase fails; a collective waits as long.
RANKS_TIMEOUT = 300.0
#: The uncompressed two-rank run (c) against train_gnn (the reference's
#: gate, tests/test_parallel.py): the halo rows are summed in another order.
MESH_RTOL, MESH_ATOL = 2e-4, 2e-5
#: Kernel-name fragments of the exchange's work on the card (gloo stages
#: CUDA tensors through host memory) and of the collectives on the host.
COPY_KEYS = ("Memcpy", "memcpy")
COLLECTIVE_KEYS = ("all_to_all", "alltoall", "all_reduce", "allreduce",
                   "gloo")


def mesh_ledger(g, cfg, n_parts: int, n_nodes: int) -> list:
    """A rank's stash per layer: the mesh section of
    activation_memory_report at the run's padded partition."""
    from repro_torch.engine.plan import ExecutionPlan, SamplingPolicy
    from repro_torch.graph.train import activation_memory_report

    plan = ExecutionPlan(sampling=SamplingPolicy(kind="mesh",
                                                 n_parts=n_parts))
    rep = activation_memory_report(g, cfg, plan=plan, batch_nodes=n_nodes)
    return [r["compressed_bytes"] for r in rep["mesh"]["per_layer"]]


def mesh_compiled(g, cfg, model, n_parts: int, group=None,
                  kind: str = "mesh"):
    """A CompiledMesh of ``n_parts`` bfs partitions on ``group`` (or, with
    ``kind="partition"``, the batched engine's CompiledPartition of the
    same partitions, unshuffled)."""
    from repro_torch.engine.compile import compile_plan
    from repro_torch.engine.plan import ExecutionPlan, SamplingPolicy
    from repro_torch.optim import AdamWConfig

    plan = ExecutionPlan(sampling=SamplingPolicy(kind=kind, n_parts=n_parts,
                                                 shuffle=False))
    return compile_plan(g, cfg, plan, model, AdamWConfig(lr=5e-3), "cuda",
                        mesh=group)


def round_shares(torch, g, cfg, model) -> dict:
    """Where a one-rank mesh round's time beyond a batched update goes
    (both are host-bound): over the 8 partitions of an epoch, after a
    warm-up epoch, the wall time of the pager's fetch and next prefetch
    alone, and of one forward and backward through the mesh's per-op stack
    and through the engine's ``_StashGNN`` on the same partition and SR
    seed; each part starts and ends with a sync.  Means in ms."""
    from repro_torch.engine import seeds
    from repro_torch.engine.compile import masked_nll
    from repro_torch.engine.forward import mesh_gnn_forward

    mesh = mesh_compiled(g, cfg, copy.deepcopy(model), 8)
    part = mesh_compiled(g, cfg, copy.deepcopy(model), 8, kind="partition")
    params = mesh.model.flat_params()
    times = {"pager": [], "per-op": [], "stash": []}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3)
        return out

    def fetch(r):
        feats = mesh.pager.fetch(r)
        mesh.pager.prefetch((r + 1) % mesh.rounds)
        return feats

    def per_op(feats, t, seed):
        logits, _, _ = mesh_gnn_forward(mesh.model, feats, t, cfg, seed=seed)
        return torch.autograd.grad(
            masked_nll(logits, t.labels, t.train_mask), params)

    for epoch in range(2):
        for v in times.values():
            v.clear()
        for r in range(mesh.rounds):
            seed = seeds.sr_seed(seeds.batch_ordinals(epoch, 8, r, 1, 0,
                                                      1)[0])
            feats = timed("pager", lambda: fetch(r))
            timed("per-op", lambda: per_op(feats, mesh.tables[r], seed))
            timed("stash", lambda: part._micro(part.graphs[r], seed))
    means = {k: statistics.mean(v) for k, v in times.items()}
    log(f"[mesh m=1] a round's parts, ms (mean of 8): pager fetch + "
        f"prefetch {means['pager']:.3f} ({mesh.pager.n_pages} pages); "
        f"forward + backward per-op {means['per-op']:.3f} against "
        f"_StashGNN {means['stash']:.3f}")
    return means


def profile_round(torch, compiled, what: str) -> dict:
    """One profiled mesh round after a warm-up round (profile_call), and
    the exchange's share of it: the device's copy time (gloo's staging of
    CUDA tensors) and the host time inside the collectives."""
    from torch.profiler import ProfilerActivity, profile

    compiled.round(0, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compiled.round(0, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
            for e in events
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    copy_ms = sum(r[0] for r in rows if any(k in r[2] for k in COPY_KEYS))
    host = [(e.cpu_time_total / 1e3, e.count, e.key) for e in events
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
            and any(k in e.key.lower() for k in COLLECTIVE_KEYS)]
    host.sort(reverse=True)
    return {"what": what, "wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "copy_ms": copy_ms,
            "rows": rows[:12] + [r for r in rows[12:]
                                 if any(k in r[2] for k in OWN_KERNELS)],
            "collectives": host[:8]}


def log_round(prof: dict) -> None:
    log(f"profiled {prof['what']}: wall {prof['wall_ms']:.3f} ms, device "
        f"busy {prof['busy_ms']:.3f} ms, idle share "
        f"{prof['idle_share']:.3f}; device copies {prof['copy_ms']:.3f} ms")
    log_profile(prof["rows"], 12)
    for ms, count, key in prof["collectives"]:
        log(f"  host {ms:9.3f} ms  x{count:<5d} {key[:100]}")


def mesh_rank(rank: int, world: int, g, cfg, raw, state: dict) -> dict:
    """Phase 10 (c)-(e) on one of two ranks sharing the card (gloo):
    launch counts set to 0 before each run and read after it, each run's
    losses, parameters, stash, exchange bytes, pager stats, epoch times and
    peak memory; rank 0 also profiles one round of (d)."""
    import copy as copy_mod

    import torch
    import torch.distributed as dist

    from repro_torch.graph.models import GNN
    from repro_torch.graph.train import train_gnn_batched, train_gnn_mesh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_matmul as fk
    from repro_torch.kernels import quant_blockwise as qk
    from repro_torch.kernels import rp_matmul as rk

    wrappers = (qk.quant_pack, qk.dequant_unpack, rk.rp_project,
                rk.irp_project, fk.matmul_quant, fk.dequant_matmul,
                fa.flash_attention)
    group = dist.group.WORLD
    model0 = GNN(cfg, g.n_feats)
    model0.load_state_dict(state)

    def counted(fn) -> dict:
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out = {"seconds": time.perf_counter() - t0,
               "launches": {w.__name__: w.launches for w in wrappers},
               "peak": torch.cuda.max_memory_allocated(),
               "losses": [h[1] for h in res["history"]],
               "ms": [h[2] for h in res["history"]],
               "params": [p.detach().cpu() for p in
                          res["model"].parameters()]}
        out.update({k: res[k] for k in (
            "stash_bytes", "halo_bytes_sent", "halo_bytes_per_epoch",
            "halo_width", "dropped_edges", "halo_edges", "batch_nodes",
            "batch_edges", "updates_per_epoch", "mesh_devices", "pager",
            "val_acc", "test_acc") if k in res})
        return out

    out = {"c": counted(lambda: train_gnn_mesh(
        g, raw, 2, n_epochs=2, seed=0, params=model0, mesh=group))}
    out["d"] = counted(lambda: train_gnn_mesh(
        g, cfg, 8, n_epochs=MESH_EPOCHS, seed=0, params=model0, mesh=group))
    compiled = mesh_compiled(g, cfg, copy_mod.deepcopy(model0).cuda(), 8,
                             group)
    if rank == 0:
        out["profile"] = profile_round(torch, compiled,
                                       "mesh round (2 ranks, rank 0)")
    else:
        compiled.round(0, 0)
        compiled.round(0, 1)
    del compiled
    out["e"] = counted(lambda: train_gnn_batched(
        g, cfg, 8, n_epochs=2, seed=0, params=model0, mesh=group,
        shuffle=False))
    return out


def slice_mesh(torch, g, cfg, model0, wrappers) -> dict:
    """Phase 10: the mesh engine on phase 4's graph, config and weights
    (the module docstring lists (a)-(e)).  Returns the launch counts
    summed over the counted runs, both ranks' included."""
    from repro_torch.graph.models import GNNConfig
    from repro_torch.graph.train import (train_gnn, train_gnn_batched,
                                         train_gnn_mesh)
    from repro_torch.parallel import run_ranks

    total = collections.Counter()

    def same(a, b) -> bool:
        return ([h[1] for h in a["history"]] == [h[1] for h in b["history"]]
                and all(torch.equal(p, q) for p, q in
                        zip(a["model"].parameters(), b["model"].parameters())))

    # (a) one rank: the 8 bfs partitions are the batched engine's batches
    steps = 8 * MESH_EPOCHS
    mesh, counts, mesh_peak = counted_run(
        torch, wrappers, planned(3, 3, steps), "mesh m=1",
        lambda: train_gnn_mesh(g, cfg, 8, n_epochs=MESH_EPOCHS, seed=0,
                               params=model0, method="bfs"))
    total.update(counts)
    batched, counts, batched_peak = counted_run(
        torch, wrappers, planned(3, 3, steps), "mesh m=1: batched",
        lambda: train_gnn_batched(g, cfg, 8, n_epochs=MESH_EPOCHS, seed=0,
                                  params=model0, shuffle=False))
    total.update(counts)
    if not same(mesh, batched):
        raise AssertionError("[mesh m=1] differs from train_gnn_batched("
                             "shuffle=False)")
    log("[mesh m=1] losses and params bit-identical to train_gnn_batched("
        "shuffle=False)")
    got = (mesh["n_parts"], mesh["batch_nodes"], mesh["batch_edges"],
           mesh["updates_per_epoch"], mesh["mesh_devices"])
    if got != (8, BATCH_NODES, BATCH_EDGES, 8, 1):
        raise AssertionError(f"[mesh m=1] n_parts, padded shape, rounds, "
                             f"ranks {got}")
    want = mesh_ledger(g, cfg, 8, BATCH_NODES)
    check_run(mesh, want, "mesh m=1")
    if want != BATCH_LEDGER:
        raise AssertionError(f"[mesh m=1] ledger {want}")
    st = mesh["pager"]
    log(f"[mesh m=1] pager {st}")
    if not (st["fetches"] == st["prefetch_hits"] == steps
            and st["round_bytes"] == BATCH_NODES * 128 * 4):
        raise AssertionError("[mesh m=1] pager fetches, hits or round bytes")
    log(f"[mesh m=1] epochs ms {[round(h[2], 3) for h in mesh['history']]}"
        f" against the batched engine's "
        f"{[round(h[2], 3) for h in batched['history']]}; "
        f"max_memory_allocated {mesh_peak} against {batched_peak} bytes")
    compiled = mesh_compiled(g, cfg, copy.deepcopy(mesh["model"]), 8)
    rounds = iter(range(2))
    profile_call(torch, lambda: compiled.round(0, next(rounds)),
                 "mesh round (1 rank)", top=12)
    del compiled
    round_shares(torch, g, cfg, mesh["model"])
    del mesh, batched

    # (b) one partition, tight padding: train_gnn bit for bit
    (full, one), counts, _ = counted_run(
        torch, wrappers, planned(3, 3, steps=4), "mesh one partition",
        lambda: (train_gnn(g, cfg, n_epochs=2, seed=0, params=model0),
                 train_gnn_mesh(g, cfg, 1, n_epochs=2, seed=0,
                                params=model0, node_multiple=1,
                                edge_multiple=1)))
    total.update(counts)
    if not same(full, one) or one["batch_nodes"] != N_NODES:
        raise AssertionError("[mesh one partition] differs from train_gnn")
    log("[mesh one partition] losses and params bit-identical to "
        "train_gnn")
    del full, one

    # (c)-(e) two ranks sharing the card over gloo
    raw = GNNConfig(arch="sage", hidden=(256, 256), n_classes=40,
                    compression=None)
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, 2, (g, cfg, raw, model0.state_dict()),
                      backend="gloo", timeout=RANKS_TIMEOUT)
    log(f"[mesh 2 ranks] (c)-(e) in {time.perf_counter() - t0:.1f} s, "
        "start-up included")
    for part in ("c", "d", "e"):
        for rank, res in enumerate(ranks):
            r = res[part]
            log(f"[mesh 2 ranks ({part}) rank {rank}] losses {r['losses']} "
                f"epoch ms {[round(x, 3) for x in r['ms']]} in "
                f"{r['seconds']:.1f} s; launches {r['launches']}; "
                f"max_memory_allocated {r['peak']} bytes; "
                + ", ".join(f"{k} {r[k]}" for k in (
                    "halo_width", "halo_edges", "dropped_edges",
                    "halo_bytes_sent", "halo_bytes_per_epoch", "batch_nodes",
                    "stash_bytes", "val_acc") if k in r))
        a, b = ranks[0][part], ranks[1][part]
        if not all(torch.equal(p, q) for p, q in zip(a["params"],
                                                     b["params"])):
            raise AssertionError(f"[mesh 2 ranks ({part})] the ranks' "
                                 "parameters differ")
        for name in counts:
            total[name] += a["launches"][name] + b["launches"][name]

    # (c) n_parts = m = 2, uncompressed: within the band of train_gnn
    c0, c1 = ranks[0]["c"], ranks[1]["c"]
    ref, counts, _ = counted_run(
        torch, wrappers, planned(0, 0, 2), "mesh (c) train_gnn",
        lambda: train_gnn(g, raw, n_epochs=2, seed=0, params=model0))
    err = max(float((p.cpu() - q.detach().cpu()).abs().max())
              for p, q in zip(c0["params"], ref["model"].parameters()))
    if not all(torch.allclose(p, q.detach().cpu(), rtol=MESH_RTOL,
                              atol=MESH_ATOL)
               for p, q in zip(c0["params"], ref["model"].parameters())):
        raise AssertionError(f"[mesh 2 ranks (c)] params outside rtol "
                             f"{MESH_RTOL} / atol {MESH_ATOL} of train_gnn "
                             f"(max abs diff {err})")
    launched = {k: c0["launches"][k] + c1["launches"][k] for k in counts}
    if (c0["dropped_edges"] != 0 or c0["halo_width"] <= 0
            or c0["halo_bytes_sent"] + c1["halo_bytes_sent"]
            != 2 * c0["halo_bytes_per_epoch"]
            or launched != planned(0, 0, 0)):
        raise AssertionError("[mesh 2 ranks (c)] dropped edges, halo width, "
                             "bytes sent or launches")
    log(f"[mesh 2 ranks (c)] within rtol {MESH_RTOL} / atol {MESH_ATOL} of "
        f"train_gnn (max abs diff {err}); losses {c0['losses']} against "
        f"{[h[1] for h in ref['history']]}; train_gnn epochs ms "
        f"{[round(h[2], 3) for h in ref['history']]}")
    del ref

    # (d) 8 compressed partitions, 4 rounds
    d0, d1 = ranks[0]["d"], ranks[1]["d"]
    for rank, d in enumerate((d0, d1)):
        want = mesh_ledger(g, cfg, 8, d["batch_nodes"])
        st = d["pager"]
        log(f"[mesh 2 ranks (d) rank {rank}] ledger {want}; pager {st}")
        if not (d["stash_bytes"] == want and d["updates_per_epoch"] == 4
                and st["fetches"] == st["prefetch_hits"] == 4 * MESH_EPOCHS
                and all(map(math.isfinite, d["losses"]))
                and d["losses"][-1] < d["losses"][0]):
            raise AssertionError(f"[mesh 2 ranks (d) rank {rank}] stash, "
                                 "rounds, pager or losses")
    launched = {k: d0["launches"][k] + d1["launches"][k] for k in counts}
    if (d0["halo_bytes_sent"] + d1["halo_bytes_sent"]
            != MESH_EPOCHS * d0["halo_bytes_per_epoch"]
            or launched != planned(3, 3, 8 * MESH_EPOCHS)):
        raise AssertionError(f"[mesh 2 ranks (d)] bytes sent or launches "
                             f"{launched}")
    log_round(ranks[0]["profile"])

    # (e) two data-parallel ranks: grad_accum=2 in one process, bit for bit
    e0, e1 = ranks[0]["e"], ranks[1]["e"]
    one, counts, _ = counted_run(
        torch, wrappers, planned(3, 3, 16), "mesh (e) grad_accum=2",
        lambda: train_gnn_batched(g, cfg, 8, n_epochs=2, seed=0,
                                  params=model0, grad_accum=2,
                                  shuffle=False))
    launched = {k: e0["launches"][k] + e1["launches"][k] for k in counts}
    if not (e0["losses"] == [h[1] for h in one["history"]]
            and all(torch.equal(p, q.detach().cpu()) for p, q in
                    zip(e0["params"], one["model"].parameters()))
            and launched == planned(3, 3, 16)):
        raise AssertionError("[mesh 2 ranks (e)] differs from grad_accum=2 "
                             f"in one process (launches {launched})")
    log("[mesh 2 ranks (e)] losses and params bit-identical to "
        "train_gnn_batched(grad_accum=2, shuffle=False) in one process; "
        f"its epochs ms {[round(h[2], 3) for h in one['history']]}")
    return dict(total)


# ------------------------------------------------- phase 11: observability
#: The full surface phase 11 (a) runs: spans, metrics and the quant-health
#: probe at epochs 0 and 2 of 3.
OBS_EPOCHS = 3
#: Phase 11 (b): pairs of obs-off / trace+metrics-on runs (off, on, on,
#: off, ...) of OVERHEAD_EPOCHS epochs; epoch 0 of each run is left out.
OVERHEAD_PAIRS = 2
OVERHEAD_EPOCHS = 8
#: The reference's overhead gate: obs-on over obs-off epoch time.
OVERHEAD_LIMIT = 1.05
#: Seconds phase 11 may take, (a)-(d) and (e) together.
PHASE11_LIMIT_S = 60.0
#: Where phase 11 writes its trace (the build directory is git-ignored).
OBS_TRACE = Path(__file__).resolve().parent / "build" / "obs" / "phase11"


def check_trace_export(obs) -> dict:
    """Export ``obs``'s trace and check both files against the reference's
    schemas (JSONL span keys; Chrome complete events in µs)."""
    paths = obs.export(OBS_TRACE)
    events = [json.loads(line) for line in
              Path(paths["jsonl"]).read_text().strip().split("\n")]
    chrome = json.loads(Path(paths["chrome"]).read_text())
    ok = (len(events) == len(obs.tracer.spans)
          and all(set(e) == {"name", "ts_s", "dur_s", "depth", "parent",
                             "args"} for e in events)
          and set(chrome) == {"traceEvents", "displayTimeUnit"}
          and all(ev["ph"] == "X" and ev["cat"] == "repro"
                  and ev["ts"] >= 0.0 and ev["dur"] >= 0.0
                  for ev in chrome["traceEvents"]))
    if not ok:
        raise AssertionError(f"[obs] exported trace {paths} off schema")
    log(f"[obs] trace exported ({len(events)} spans): {paths}")
    return paths


def same_run(torch, a: dict, b: dict) -> bool:
    """Losses, parameters and the live stash bit-identical."""
    return ([h[1] for h in a["history"]] == [h[1] for h in b["history"]]
            and a["stash_bytes"] == b["stash_bytes"]
            and all(torch.equal(p, q) for p, q in
                    zip(a["model"].parameters(), b["model"].parameters())))


def timed_allocate(torch, ctrl, model, reps: int = 3) -> list:
    """Host ms of ``reps`` synchronized ``ctrl.allocate(model)`` calls,
    after one warm-up."""
    ctrl.allocate(model)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl.allocate(model)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def slice_obs(torch, g, cfg, model0, wrappers) -> dict:
    """Phase 11 (a)-(d): observability on phase 4's graph, config and
    weights (the module docstring lists them).  Returns the launch counts
    summed over the counted runs."""
    from repro_torch.core import autoprec
    from repro_torch.engine.plan import (ExecutionPlan, ObsPolicy,
                                         PrecisionPolicy, SamplingPolicy)
    from repro_torch.engine.precision import AutoprecController
    from repro_torch.engine.runner import run
    from repro_torch.graph.analysis import collect_layer_stats
    from repro_torch.graph.models import device_graph
    from repro_torch.obs.quantstats import measure_quant_health

    total = collections.Counter()
    full = ExecutionPlan()
    quant = ObsPolicy(enabled=True, quant_stats=True, quant_stats_every=2)

    # (a) the full graph: obs-off, then the full surface with 2 probes
    off, counts, off_peak = counted_run(
        torch, wrappers, planned(3, 3, OBS_EPOCHS), "obs off",
        lambda: run(g, cfg, full, n_epochs=OBS_EPOCHS, seed=0,
                    params=model0))
    total.update(counts)
    on, counts, on_peak = counted_run(
        torch, wrappers, planned(3, 3, OBS_EPOCHS, quant_probes=2),
        "obs on", lambda: run(g, cfg, dataclasses.replace(full, obs=quant),
                              n_epochs=OBS_EPOCHS, seed=0, params=model0))
    total.update(counts)
    if not same_run(torch, off, on):
        raise AssertionError("[obs on] losses, params or stash differ from "
                             "obs off")
    log("[obs on] losses, params and stash bit-identical to obs off; "
        f"max_memory_allocated {on_peak} bytes on, {off_peak} off")
    obs = on["obs"]
    rows = obs.quant_rows()
    for r in rows:
        log(f"[obs probe] epoch {r['epoch']} layer {r['layer']}: "
            f"measured_var {r['measured_var']!r} predicted_var "
            f"{r['predicted_var']!r} ratio {r['ratio']!r} sat_rate "
            f"{r['sat_rate']!r} rng_sq_mean {r['rng_sq_mean']!r} "
            f"n_elements {r['n_elements']} n_blocks {r['n_blocks']}")
    if len(rows) != 3 or not all(r["epoch"] == 2 and math.isfinite(
            r["ratio"]) and r["measured_var"] > 0 for r in rows):
        raise AssertionError(f"[obs probe] rows {rows}")
    spans = obs.tracer.spans
    probe_ms = [s.dur * 1e3 for s in spans if s.name == "obs/quant_probe"]
    epoch_ms = [s.dur * 1e3 for s in spans if s.name == "epoch"]
    if len(probe_ms) != 2 or len(epoch_ms) != OBS_EPOCHS:
        raise AssertionError("[obs on] probe or epoch spans")
    log(f"[obs on] spans: epoch ms {epoch_ms} (the loss read-back waits "
        f"for the card), obs/quant_probe ms {probe_ms} (each waits for its "
        f"copy to the host), metrics {obs.registry.snapshot()}; history ms "
        f"on {[h[2] for h in on['history']]}, off "
        f"{[h[2] for h in off['history']]}")
    check_trace_export(obs)
    # the probe alone, drained, at the trained weights
    dg = device_graph(g, cfg.arch, "cuda")
    model = on["model"]
    measure_quant_health(model, dg, cfg)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        measure_quant_health(model, dg, cfg)
        times.append((time.perf_counter() - t0) * 1e3)
        probe_peak = torch.cuda.max_memory_allocated() - base
    log(f"[obs probe] alone (drained, host clock): {times} ms; peak "
        f"{probe_peak} bytes above the {base} allocated before it")
    del off, on, obs, rows, spans

    # (b) overhead: paired obs-off / trace+metrics-on runs
    tm = dataclasses.replace(full, obs=ObsPolicy(enabled=True))
    order = [False, True, True, False] * (OVERHEAD_PAIRS // 2)
    ms = {False: [], True: []}

    def overhead_runs():
        for on_ in order:
            r = run(g, cfg, tm if on_ else full, n_epochs=OVERHEAD_EPOCHS,
                    seed=0, params=model0)
            ms[on_].extend(h[2] for h in r["history"][1:])

    _, counts, _ = counted_run(
        torch, wrappers, planned(3, 3, OVERHEAD_EPOCHS * len(order)),
        "obs overhead", overhead_runs)
    total.update(counts)
    ratio = statistics.median(ms[True]) / statistics.median(ms[False])
    log(f"[obs overhead] epoch ms off {ms[False]}; on {ms[True]}; median "
        f"{statistics.median(ms[True])!r} / "
        f"{statistics.median(ms[False])!r} = {ratio!r}")
    if not ratio < OVERHEAD_LIMIT:
        raise AssertionError(f"[obs overhead] ratio {ratio} not below "
                             f"{OVERHEAD_LIMIT}")

    # (c) autoprec at bit_budget 2.0 calibrated from the probe: allocate
    # and re-solve at epoch 2 (a stats pass and a probe each), and the
    # loop's probe at epoch 0
    ap = ExecutionPlan(
        precision=PrecisionPolicy(kind="autoprec", bit_budget=2.0,
                                  refresh=2, calibration="obs"),
        obs=ObsPolicy(enabled=True, quant_stats=True,
                      quant_stats_every=1000))
    res, counts, peak = counted_run(
        torch, wrappers, planned(3, 3, steps=4, stats=2, quant_probes=3),
        "obs autoprec", lambda: run(g, cfg, ap, n_epochs=4, seed=0,
                                    params=model0))
    total.update(counts)
    bits, budget = res["bits_per_layer"], res["bit_budget_bytes"]
    stats = collect_layer_stats(res["model"], dg, cfg)
    alloc_bytes = autoprec.total_stash_bytes(stats,
                                             res["cfg"].layer_compression())
    log(f"[obs autoprec] bits_per_layer {bits} bit_budget_bytes {budget} "
        f"allocation bytes {alloc_bytes} losses "
        f"{[h[1] for h in res['history']]} max_memory_allocated {peak}")
    if not all(b in autoprec.BIT_CHOICES for b in bits) or \
            alloc_bytes > budget:
        raise AssertionError(f"[obs autoprec] allocation {bits} "
                             f"({alloc_bytes} bytes) outside BIT_CHOICES "
                             "or the budget")
    resolve = {c: timed_allocate(torch, AutoprecController(
        dg, cfg, 2.0, 2, 0, c), res["model"]) for c in ("obs", "probe")}
    log(f"[obs autoprec] re-solve ms, calibration='obs' {resolve['obs']} "
        f"against 'probe' {resolve['probe']}")
    del res, stats, dg

    # (d) phase 10 (a)'s one-rank mesh, 2 epochs, obs off and on
    mesh = ExecutionPlan(sampling=SamplingPolicy(kind="mesh", n_parts=8,
                                                 method="bfs",
                                                 shuffle=False))
    steps = 8 * 2
    (m_off, m_on), counts, _ = counted_run(
        torch, wrappers, planned(3, 3, 2 * steps), "obs mesh",
        lambda: tuple(run(g, cfg, plan, n_epochs=2, seed=0, params=model0)
                      for plan in (mesh, dataclasses.replace(
                          mesh, obs=ObsPolicy(enabled=True)))))
    total.update(counts)
    if not same_run(torch, m_off, m_on):
        raise AssertionError("[obs mesh] obs on differs from obs off")
    snap = m_on["obs"].registry.snapshot()
    names = [s.name for s in m_on["obs"].tracer.spans]
    got = (names.count("mesh/round"), names.count("pager/fetch"),
           snap["pager/fetches"], snap["pager/overlap_frac"]["count"])
    log(f"[obs mesh] bit-identical to obs off; mesh/round, pager/fetch "
        f"spans, pager/fetches, overlap_frac count {got}; halo/bytes "
        f"{snap['halo/bytes']} sent {m_on['halo_bytes_sent']}; overlap "
        f"{snap['pager/overlap_frac']}")
    if got != (steps,) * 4 or snap["halo/bytes"] != m_on["halo_bytes_sent"]:
        raise AssertionError(f"[obs mesh] counts {got}, halo/bytes "
                             f"{snap['halo/bytes']}")
    return dict(total)


def slice_obs_serve(torch, wrappers, model, device_out) -> dict:
    """Phase 11 (e): phase 9 (e)'s ``device`` recipe with
    ``ObsPolicy(enabled=True)`` (``--obs``): its tokens and logits, every
    request completed and the TTFT histogram counting each."""
    from repro_torch.launch import serve

    args = serve.parser().parse_args(SERVE9_ARGV + ["--obs"])
    engine, requests = serve.build_engine(args, model, collect_logits=True)
    out, counts, peak = counted_run(
        torch, wrappers, dict(planned(0, 0, 0), **SERVE9_LAUNCHES),
        "serve obs", lambda: engine.run(requests))
    for a, b in zip(device_out["results"], out["results"]):
        if not (np.array_equal(a.tokens, b.tokens) and np.array_equal(
                device_out["logits"][a.rid], out["logits"][b.rid])):
            raise AssertionError(f"[serve obs] request {a.rid} differs "
                                 "from phase 9 (e)'s device run")
    snap = engine.session.registry.snapshot()
    log(f"[serve obs] tokens and logits identical to phase 9 (e)'s; TTFT "
        f"{out['ttft_mean_ms']!r} ms, TPOT {out['tpot_mean_ms']!r} ms, "
        f"max_memory_allocated {peak} bytes; metrics {snap}")
    if not (snap["serve/completed"] == snap["serve/admitted"] == 2
            and snap["serve/ttft_ms"]["count"] == 2):
        raise AssertionError(f"[serve obs] counters {snap}")
    return counts


#: Phase 9 (e): phase 8's recipe on 2 requests of 1000 + 8 tokens, 2 slots.
SERVE9_ARGV = ["--arch", "qwen1.5-4b", "--requests", "2", "--max-batch", "2",
               "--prompt-len", "1000", "--gen-len", "8", "--kv-bits", "4",
               "--kv-group", "64", "--page-tokens", "16", "--mode",
               "continuous", "--device", "cuda"]
#: One prefill group (40 layers of flash; quant_pack per layer and stream)
#: and 7 decode steps (quant_pack per layer and stream, dequant_unpack per
#: layer and page of a slot's ceil((1000 + 8 - 1) / 16) = 63).
SERVE9_LAUNCHES = {"flash_attention": 40, "quant_pack": 80 + 7 * 80,
                   "dequant_unpack": 7 * 40 * 63}
#: 40 layers x 126 pages (2 x 63) x 51,200 bytes.
SERVE9_POOL_BYTES = 258_048_000


def check_serve9_shapes(torch, qk, fa, ref, gen) -> None:
    """The kernels at phase 9 (e)'s shapes against their plain versions:
    flash at (40, 1000, 128) bf16 (as check_flash's tolerance), the seeded
    quant_pack at the 2-request prefill and decode rows and dequant_unpack
    at K and V of a page of each of the 2 slots, bit-equal."""
    from repro_torch.engine.seeds import kv_seed

    q, k, v = (torch.randn((40, 1000, 128), device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True, scale_q=True)
    want = ref.flash_attention(q, k, v, causal=True, scale_q=True)
    if not torch.allclose(got.float(), want.float(), atol=1e-3,
                          rtol=2.0 ** -7):
        raise AssertionError("[serve9] flash at (40, 1000, 128) bf16")
    for n_tok in (2 * 1008, 2):
        x = torch.randn((n_tok * KV_NBT, KV_G), device="cuda", generator=gen)
        seeds = kv_seed(torch.arange(n_tok, device="cuda") % 1008,
                        torch.arange(n_tok, device="cuda") // 1008, 3, 0)
        if not all(torch.equal(a, b) for a, b in zip(
                qk.quant_pack(x, KV_BITS, seeds, rows_per_seed=KV_NBT),
                ref.quantize_packed(x, KV_BITS, seeds,
                                    rows_per_seed=KV_NBT))):
            raise AssertionError(f"[serve9] quant_pack at {n_tok} tokens")
    x = torch.randn((2 * 2 * 16 * KV_NBT, KV_G), device="cuda",
                    generator=gen)
    pk, zk, rk = qk.quant_pack(x, KV_BITS, 9)
    if not torch.equal(qk.dequant_unpack(pk, zk, rk, KV_BITS, KV_G),
                       ref.dequantize_packed(pk, zk, rk, KV_BITS, KV_G)):
        raise AssertionError("[serve9] dequant_unpack at a page")
    log("[serve9] flash, seeded quant_pack and dequant_unpack at phase 9 "
        "(e)'s shapes: within bands / bit-equal")


def slice_offload_serve(torch, wrappers) -> tuple:
    """Phase 9 (e): the KV cache under device, host and pinned-paged:
    launches as planned, the same tokens and logits bit for bit, the pool
    on the host (pinned for pinned-paged) with the layout's bytes, TTFT,
    TPOT and peak memory of each.  Returns the launch counts summed over
    the runs, the model and the ``device`` run's output (phase 11 (e)
    serves them again)."""
    from repro_torch.launch import serve
    from repro_torch.serving.kvcache import pool_nbytes

    model = serve.build_model(serve.parser().parse_args(SERVE9_ARGV))
    total = collections.Counter()
    outs = {}
    for policy in ("device", "host", "pinned-paged"):
        args = serve.parser().parse_args(SERVE9_ARGV
                                         + ["--kv-policy", policy])
        engine, requests = serve.build_engine(args, model,
                                              collect_logits=True)
        what = f"serve9 kv-policy={policy}"
        out, counts, peak = counted_run(torch, wrappers, dict(
            planned(0, 0, 0), **SERVE9_LAUNCHES), what,
            lambda: engine.run(requests))
        total.update(counts)
        outs[policy] = out
        pinned = (None if policy == "device" else
                  all(t.is_pinned() for t in engine.pool.host.values()))
        want_pinned = {"device": None, "host": False,
                       "pinned-paged": True}[policy]
        pool_bytes = pool_nbytes(engine.pool)
        log(f"[{what}] mechanism {engine.mechanism}, pool {pool_bytes} "
            f"bytes (pinned {pinned}), TTFT "
            f"{out['ttft_mean_ms']!r} ms, TPOT {out['tpot_mean_ms']!r} ms, "
            f"wall {out['wall_s']!r} s, max_memory_allocated {peak} bytes")
        if pool_bytes != SERVE9_POOL_BYTES or pinned is not want_pinned:
            raise AssertionError(f"[{what}] pool bytes or pinning")
        if any(r.status != "done" or len(r.tokens) != 8
               for r in out["results"]):
            raise AssertionError(f"[{what}] a request was not served")
        del engine
    base = outs["device"]
    for policy in ("host", "pinned-paged"):
        for a, b in zip(base["results"], outs[policy]["results"]):
            if not (np.array_equal(a.tokens, b.tokens) and np.array_equal(
                    base["logits"][a.rid], outs[policy]["logits"][b.rid])):
                raise AssertionError(f"[serve9] {policy}: request {a.rid} "
                                     "differs from the device policy")
    log("[serve9] host and pinned-paged: tokens and logits bit-equal to "
        "the device policy's")
    return dict(total), model, base


# ------------------------------------------------ phase 12: the launcher
#: Seconds phase 12 may take in all.
PHASE12_LIMIT_S = 150.0
#: The launcher's graph half at phase 4's size: arxiv-like at full scale,
#: SAGE 256-256, INT2, G = 256, RP 8.
GRAPH_ARGV = ["--graph-dataset", "arxiv", "--graph-scale", "1.0",
              "--act-mode", "act", "--device", "cuda"]
#: The launcher's LM half: qwen1.5-4b at full width and depth.  Five steps
#: leave no warmup (``--steps // 5``), and AdamW's first step moves every
#: random weight by about lr: the default 3e-4 raised the loss from 12.40
#: to 17.14 at this width (H100 80GB HBM3), so the smoke asks for 3e-5.
LM_LR = 3e-5
LM_ARGV = ["--arch", "qwen1.5-4b", "--batch", "2", "--seq", "1024",
           "--lr", str(LM_LR), "--act-mode", "act", "--steps", "5",
           "--device", "cuda"]
LM_LAYERS_SHORT = 8
#: Resume at the smoke width (a full checkpoint would be ~47 GB).
SMOKE_LM_ARGV = ["--arch", "qwen1.5-4b", "--smoke", "--batch", "2", "--seq",
                 "64", "--act-mode", "act", "--device", "cuda"]
BUILD = Path(__file__).resolve().parent / "build"


def launcher(train, argv: list, fn) -> tuple:
    """``fn(args)`` on the launcher's parsed ``argv`` with its report
    captured; logs the report, returns (result, report text)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(train.parser().parse_args(argv))
    text = out.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    return res, text


def same_model(torch, a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))


def slice_launcher_graph(torch, wrappers) -> collections.Counter:
    """Phase 12 (a): the launcher's graph half at phase 4's size."""
    from repro_torch.core import autoprec
    from repro_torch.engine import run
    from repro_torch.graph import activation_memory_report
    from repro_torch.graph.analysis import collect_layer_stats
    from repro_torch.graph.models import device_graph
    from repro_torch.graph.sampling import make_subgraph_batches
    from repro_torch.graph.train import train_gnn_batched
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig

    total = collections.Counter()
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)

    # 1. 8 batches, 3 epochs: engine.runner.run on the same plan, bit for bit
    want = planned(3, 3, steps=8 * 3)
    (res, text), counts, peak = counted_run(
        torch, wrappers, want, "launcher graph batches",
        lambda: launcher(train, GRAPH_ARGV + ["--graph-batches", "8",
                                              "--steps", "3"],
                         train.graph_main))
    total.update(counts)
    g, plan = res["graph"], res["plan"]
    ref, counts, _ = counted_run(
        torch, wrappers, want, "launcher graph batches: run",
        lambda: run(g, res["cfg"], plan, opt, n_epochs=3, seed=0))
    total.update(counts)
    if not ([h[1] for h in res["history"]] == [h[1] for h in ref["history"]]
            and same_model(torch, res["model"], ref["model"])):
        raise AssertionError("[launcher graph] not engine.runner.run on the "
                             "same plan, bit for bit")
    rep = activation_memory_report(g, res["cfg"],
                                   batch_nodes=res["batch_nodes"], plan=plan)
    line = (f"peak saved-activation bytes/batch: "
            f"{rep['batched']['peak_saved_bytes'] / 1e6:.2f} MB")
    ledger = [r.get("compressed_bytes", r["fp32_bytes"])
              for r in rep["batched"]["per_layer"]]
    log(f"[launcher graph] epochs {[h for h in res['history']]}; run's "
        f"{[h for h in ref['history']]}; bit-identical; live stash "
        f"{res['stash_bytes']} ledger {ledger}; max_memory_allocated {peak}")
    if line not in text or res["stash_bytes"] != ledger:
        raise AssertionError("[launcher graph] the printed peak or the live "
                             "stash differs from activation_memory_report")

    # 2. the mesh engine on one rank: the batched engine without shuffling
    (res, _), counts, _ = counted_run(
        torch, wrappers, planned(3, 3, steps=8 * 2), "launcher mesh",
        lambda: launcher(train, GRAPH_ARGV + ["--mesh-parts", "8",
                                              "--steps", "2"],
                         train.graph_main))
    total.update(counts)
    batched = train_gnn_batched(g, res["cfg"], 8, n_epochs=2, seed=0,
                                shuffle=False)
    if not ([h[1] for h in res["history"]]
            == [h[1] for h in batched["history"]]
            and same_model(torch, res["model"], batched["model"])):
        raise AssertionError("[launcher mesh] not train_gnn_batched("
                             "shuffle=False), bit for bit")
    log(f"[launcher mesh] epochs {res['history']}: train_gnn_batched("
        "shuffle=False) bit for bit")

    # 3. the arena, autoprec (allocated once) and obs with a trace
    trace = BUILD / "obs" / "phase12"
    for suffix in (".jsonl", ".trace.json"):
        Path(f"{trace}{suffix}").unlink(missing_ok=True)
    argv = GRAPH_ARGV + ["--graph-batches", "8", "--offload", "device",
                         "--bit-budget", "2.0", "--obs", "--trace-out",
                         str(trace), "--steps", "3"]
    (res, text), counts, peak = counted_run(
        torch, wrappers, planned(3, 3, steps=8 * 3, probes=2, stats=1,
                                 quant_probes=1),
        "launcher arena autoprec obs", lambda: launcher(
            train, argv, train.graph_main))
    total.update(counts)
    bits, budget = res["bits_per_layer"], res["bit_budget_bytes"]
    batch0 = make_subgraph_batches(g, 8, method="bfs", seed=0)[0]
    alloc = autoprec.total_stash_bytes(
        collect_layer_stats(res["model"], device_graph(batch0, "sage",
                                                       "cuda"), res["cfg"]),
        res["cfg"].layer_compression())
    files = [Path(f"{trace}{suffix}") for suffix in (".jsonl",
                                                     ".trace.json")]
    log(f"[launcher arena autoprec obs] bits {bits}, allocation {alloc} of "
        f"the budget's {budget} bytes, live stash {res['stash_bytes']}, "
        f"arena {res['arena']}, trace files "
        f"{[(str(f), f.stat().st_size) for f in files if f.exists()]}, "
        f"max_memory_allocated {peak}")
    if not (all(b in autoprec.BIT_CHOICES for b in bits) and alloc <= budget
            and "stash arena[device]" in text
            and all(f.exists() and f.stat().st_size for f in files)):
        raise AssertionError("[launcher arena autoprec obs] widths, budget, "
                             "arena line or trace files")
    return total


def lm_residual(torch, model, tokens, vocab_chunk: int) -> int:
    """The device bytes the loss's graph holds for its backward: allocated
    with the graph alive, less allocated once the backward has run and its
    outputs are released (as phase 9's probe measures)."""
    params = list(model.parameters())
    torch.cuda.synchronize()
    loss = model.loss(tokens, act_seed=1, vocab_chunk=vocab_chunk)
    torch.cuda.synchronize()
    with_graph = torch.cuda.memory_allocated()
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    del loss, grads
    return with_graph - torch.cuda.memory_allocated()


def lm_short(torch, train, mode: str, offload: str = "none",
             argv: list = LM_ARGV) -> dict:
    """2 steps of the launcher's LM (``argv``'s model) at full width and
    LM_LAYERS_SHORT layers (seed-0 weights, the same for every mode) on
    B 2 x 1024 tokens, with the peak, step times and the loss graph's
    residual bytes."""
    from repro_torch.data import batch_for_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init

    args = train.parser().parse_args(
        argv[:argv.index("--act-mode")] + ["--act-mode", mode,
                                           "--offload", offload,
                                           "--device", "cuda"])
    cfg = dataclasses.replace(train.lm_config(args),
                              n_layers=LM_LAYERS_SHORT)
    model = Model(cfg, generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamWConfig(lr=LM_LR, weight_decay=0.01, grad_clip=1.0)
    step = make_train_step(model, opt)
    state = adamw_init(list(model.parameters()), opt)
    tokens = [torch.as_tensor(batch_for_step(cfg.vocab, 2, 1024, i),
                              device="cuda") for i in range(2)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(2):
        t0 = time.perf_counter()
        losses.append(float(step(state, {"tokens": tokens[i]})["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    residual = lm_residual(torch, model, tokens[0], cfg.vocab_chunk)
    log(f"[lm {cfg.name} {LM_LAYERS_SHORT} layers {mode} offload="
        f"{offload}] losses "
        f"{losses} step ms {ms} max_memory_allocated {peak} ({peak - base} "
        f"above the {base} of weights and moments); loss graph residual "
        f"{residual} bytes")
    return {"losses": losses, "ms": ms, "peak": peak, "residual": residual,
            "model": model}


def slice_launcher_lm(torch, wrappers) -> collections.Counter:
    """Phase 12 (b): the launcher's LM half, qwen1.5-4b at full width and
    depth under ``act``, then 8 layers under none / remat / act and the
    pinned-paged stash."""
    from repro_torch.configs import get
    from repro_torch.launch import train

    total = collections.Counter()
    cfg = get("qwen1.5-4b")
    n_params = cfg.param_count()
    toks = 2 * 1024
    stash = cfg.n_layers * (toks * cfg.d_model // 4
                            + toks * cfg.d_model // 256 * 8)
    logits = 2 * 2048 * cfg.vocab * 4
    log(f"[lm] reckoning: {n_params} parameters, bf16 weights and grads "
        f"{2 * n_params} + {2 * n_params} bytes, float32 AdamW moments "
        f"{8 * n_params}, INT2 stashes {stash}, a loss chunk's float32 "
        f"logits {logits} (and as much again for their gradient)")
    steps = 5
    (res, text), counts, peak = counted_run(
        torch, wrappers, dict(planned(0, 0, 0),
                              quant_pack=cfg.n_layers * steps,
                              dequant_unpack=cfg.n_layers * steps),
        "launcher lm", lambda: launcher(train, LM_ARGV, train.lm_main))
    total.update(counts)
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    log(f"[launcher lm] qwen1.5-4b 40 layers act: losses {losses}; step s "
        f"{[h['dt'] for h in hist]}; max_memory_allocated {peak} bytes")
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"[launcher lm] losses {losses}")
    batch = res["make_batch"](steps)
    profile_call(torch, lambda: float(res["step_fn"](
        (res["model"], res["opt_state"]), batch)[1]["loss"]),
        "lm step (qwen1.5-4b, 40 layers, act, B 2 x 1024)", top=20)
    del res, batch
    torch.cuda.empty_cache()

    runs = {}
    for mode in ("none", "remat", "act"):
        runs[mode] = lm_short(torch, train, mode)
        del runs[mode]["model"]
        torch.cuda.empty_cache()
    log("[lm 8 layers] peak / residual bytes / step ms: " + "; ".join(
        f"{m} {r['peak']} / {r['residual']} / {r['ms']}"
        for m, r in runs.items()))
    res_order = [runs[m]["residual"] for m in ("act", "remat", "none")]
    if not res_order[0] < res_order[1] < res_order[2]:
        raise AssertionError(f"[lm 8 layers] loss graph residual bytes act "
                             f"< remat < none fails: {res_order}")
    dev = lm_short(torch, train, "act")
    pinned = lm_short(torch, train, "act", "pinned-paged")
    if not (dev["losses"] == pinned["losses"]
            and same_model(torch, dev["model"], pinned["model"])):
        raise AssertionError("[lm 8 layers] pinned-paged stash is not the "
                             "device stash bit for bit")
    log("[lm 8 layers] act with the pinned-paged stash: losses and params "
        "bit-identical to the device stash")
    del dev, pinned
    torch.cuda.empty_cache()
    return total


def slice_launcher_resume(torch, wrappers) -> collections.Counter:
    """Phase 12 (c): checkpoint and resume at the smoke width."""
    import shutil

    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.launch import train

    total = collections.Counter()
    ckpt = BUILD / "ckpt" / "phase12"
    failed = BUILD / "ckpt" / "phase12_fail"
    for d in (ckpt, failed):
        shutil.rmtree(d, ignore_errors=True)
    n_layers = 2

    def lm(argv, steps):
        res, counts, _ = counted_run(
            torch, wrappers, dict(planned(0, 0, 0),
                                  quant_pack=n_layers * steps,
                                  dequant_unpack=n_layers * steps),
            f"launcher resume {argv[-6:]}",
            lambda: launcher(train, SMOKE_LM_ARGV + argv, train.lm_main)[0])
        total.update(counts)
        return res

    whole = lm(["--steps", "6"], 6)
    lm(["--steps", "4", "--ckpt-dir", str(ckpt), "--ckpt-every", "2"], 4)
    resumed = lm(["--steps", "6", "--ckpt-dir", str(ckpt), "--ckpt-every",
                  "2"], 2)
    hist = resumed["history"]
    log(f"[launcher resume] resumed steps {[h['step'] for h in hist]} losses "
        f"{[h['loss'] for h in hist]}; uninterrupted "
        f"{[h['loss'] for h in whole['history']]}")
    if not ([h["step"] for h in hist] == [4, 5]
            and [h["loss"] for h in hist]
            == [h["loss"] for h in whole["history"][4:]]
            and same_model(torch, resumed["model"], whole["model"])):
        raise AssertionError("[launcher resume] not the uninterrupted run "
                             "bit for bit")
    try:
        lm(["--steps", "6", "--ckpt-dir", str(failed), "--ckpt-every", "2",
            "--fail-at", "3"], 3)
    except RuntimeError as exc:
        log(f"[launcher resume] --fail-at 3 raised: {exc}")
    else:
        raise AssertionError("[launcher resume] --fail-at 3 did not raise")
    like = (whole["model"], whole["opt_state"])
    state = load_checkpoint(failed, 2, like)
    if latest_step(failed) != 2 or state[1]["step"] != 2:
        raise AssertionError("[launcher resume] step_2 not intact")
    log("[launcher resume] after the failure: latest step 2, which loads "
        "with its step counter 2")
    return total


# -------------------------------------------------- phase 13: the MoE family
#: Seconds phase 13 may take in all.
PHASE13_LIMIT_S = 150.0
MOE_ARCH = "qwen3-moe-235b-a22b"
#: qwen3-moe-235b-a22b at full width, cut from 94 layers to 12 (~62 GB of
#: bf16 weights; the 80 GB card holds 13 at most beside the serving run).
MOE_SERVE_LAYERS = 12
#: Phase 8's traffic on the MoE model: the launcher's flags but the arch.
MOE_SERVE_ARGV = ["--arch", MOE_ARCH] + SERVE_ARGV[2:]
#: The serving prefill's attention: 4 prompts x 64 query heads.
MOE_FLASH_SHAPE = (256, 1000, 128)
#: A token's K (or V) at 4 KV heads x 128: 8 blocks of G = 64.
MOE_KV_NBT = 4 * 128 // KV_G
#: Phase 8's launch formula at MOE_SERVE_LAYERS layers (2 prefill groups,
#: 62 decode steps, 65 pages a slot, K and V each a quant_pack launch).
MOE_SERVE_LAUNCHES = {
    "flash_attention": 2 * MOE_SERVE_LAYERS,
    "quant_pack": (2 + 62) * 2 * MOE_SERVE_LAYERS,
    "dequant_unpack": 62 * MOE_SERVE_LAYERS * SERVE_PAGES_PER_SLOT}
#: 12 layers x 260 pages x 2 x (16 tokens x 512 elements at 4 bits + 16 x 8
#: blocks x 8 bytes of zero and range).
MOE_SERVE_POOL_BYTES = MOE_SERVE_LAYERS * 260 * 2 * (16 * 512 // 2
                                                     + 16 * 8 * 8)
#: The 8-bit AdamW moments of one expert stack (128, 4096, 1536): blocks
#: of 256.  The plain quantizer's int64 transients of the whole stack
#: (6 GB each) do not fit beside it, so the plain comparison runs on 16
#: experts' blocks (an eighth) and the kernel is also timed on the whole.
MOE_MOMENT_BLOCKS = 128 * 4096 * 1536 // 256
MOE_MOMENT_PLAIN_BLOCKS = MOE_MOMENT_BLOCKS // 8
#: Tokens of the MoE layer check's sample, and its band on y (bf16 output
#: of three bf16 products against float32 products from the same bf16
#: inputs): 2**-6 of the sample's largest |y| plus 2**-6 relative.
MOE_SAMPLE = 256
MOE_BAND = 2.0 ** -6
#: arctic-480b at full width, 2 of its 35 layers (~27.2 GB each).
ARCTIC_ARGV = ["--arch", "arctic-480b", "--requests", "2", "--max-batch",
               "2", "--prompt-len", "256", "--gen-len", "8", "--kv-bits", "4",
               "--kv-group", "64", "--page-tokens", "16", "--device", "cuda"]
ARCTIC_LAYERS = 2
#: The launcher's MoE LM half: full width, 1 layer, the config's grad_accum
#: 8 splitting B 8 into micro-batches of 1 x 512.
MOE_LM_ARGV = ["--arch", MOE_ARCH, "--act-mode", "remat", "--opt-bits", "8",
               "--batch", "8", "--seq", "512", "--steps", "5", "--lr",
               str(LM_LR), "--device", "cuda"]


@contextlib.contextmanager
def plain_attention_on_card(ref, calls: list):
    """Inside: every call of the plain attention with a CUDA tensor adds
    one to ``calls[0]`` (the serving path must run none)."""
    plain = ref.flash_attention

    def counted(q, *a, **kw):
        calls[0] += q.is_cuda
        return plain(q, *a, **kw)

    ref.flash_attention = counted
    try:
        yield
    finally:
        ref.flash_attention = plain


def layer_tree(module) -> dict:
    """A layer module's parameters as the nested dict ``Model`` takes,
    sharing their storage."""
    tree = {n: p.data for n, p in module.named_parameters(recurse=False)}
    tree.update({n: layer_tree(c) for n, c in module.named_children()})
    return tree


def model_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def check_moe_shapes(torch, fa, qk, ref) -> dict:
    """Phase 13's kernels at the MoE path's shapes against their plain
    versions, timed: flash at the serving prefill's (256, 1000, 128) bf16
    beside SDPA, the seeded quant_pack and page dequant_unpack at 4 KV
    heads, and the 8-bit AdamW moments of an eighth of one (128, 4096,
    1536) expert stack (and the kernels alone on the whole stack)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = check_flash(torch, fa, ref, flush, gen, MOE_FLASH_SHAPE, "moe ")
    rows.update(check_kv_quant(torch, qk, ref, flush, gen, MOE_KV_NBT,
                               "moe "))
    tag, q, d = quant_case(torch, qk, ref, MOE_MOMENT_PLAIN_BLOCKS, 256, 8,
                           None, flush, gen, plain_iters=3)
    rows[("quant_pack", f"moe adamw8 {tag}")] = q
    rows[("dequant_unpack", f"moe adamw8 {tag}")] = d
    n = MOE_MOMENT_BLOCKS
    x = torch.randn((n, 256), device="cuda", generator=gen)
    words = qk.quant_pack(x, 8, 1234)
    # an element's noise counter is its index in the stack, so the whole
    # stack's first eighth is the plain version's of that eighth alone
    m = MOE_MOMENT_PLAIN_BLOCKS
    head = ref.quantize_packed(x[:m], 8, 1234)
    if not all(torch.equal(a[:m], b) for a, b in zip(words, head)):
        raise AssertionError("quant_pack moe adamw8 whole stack: its first "
                             "eighth is not the plain version's")
    del head
    nbytes = n * (256 * 4 + 256 + 8)
    for name, fn, ops in (
            ("quant_pack", lambda: qk.quant_pack(x, 8, 1234), 18),
            ("dequant_unpack", lambda: qk.dequant_unpack(*words, 8, 256), 4)):
        bnd = bound(nbytes, ops * n * 256)
        row = dict(ms=time_ms(torch, fn, flush, 5), plain_ms=None,
                   bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                   max_abs_err=0.0, bytes=nbytes)
        log(f"{name} moe adamw8 whole stack {n}x256 int8 (its first "
            f"eighth bit-equal to the plain version's): {row}")
        rows[(name, f"moe adamw8 whole stack {n}x256")] = row
    del flush, x, words
    torch.cuda.empty_cache()
    return rows


def host_routing(probs: np.ndarray, k: int, c: int) -> dict:
    """The dispatch plan recomputed on the host from (B, S, E) float32
    probabilities, with no sort: the k largest per token (descending),
    each pair's position its expert's count of earlier pairs in token
    order, ``keep = pos < c``, ``slot = idx*c + pos`` or the dummy E*c."""
    b, s, e = probs.shape
    idx = np.argsort(-probs, axis=-1, kind="stable")[..., :k]
    flat = idx.reshape(b, s * k)
    onehot = flat[..., None] == np.arange(e)                 # (B, S*k, E)
    before = np.cumsum(onehot, axis=1) - onehot
    pos = np.take_along_axis(before, flat[..., None], 2)[..., 0]
    pos = pos.reshape(b, s, k)
    keep = pos < c
    return {"idx": idx, "keep": keep,
            "slot": np.where(keep, idx * c + pos, e * c)}


def check_moe_layer(torch, model) -> dict:
    """Phase 13 (b): one full-width MoE layer (layer 0 of ``model``) at
    the prefill's (4, 1000, 4096), bf16 activations from a seed.  The
    card's routing (idx, keep, slot) must equal the host's recomputation
    from the card's own probabilities exactly; on MOE_SAMPLE tokens, y must
    agree with a float32 loop over each token's kept experts (sum of gate
    times that expert's SwiGLU) within MOE_BAND.  Times the layer at the
    prefill's and at a decode step's shape."""
    import torch.nn.functional as F

    from repro_torch.models import moe

    cfg, lp = model.cfg, model.layers[0].moe
    e, k, n = cfg.n_experts, cfg.top_k, 4000
    gen = torch.Generator(device="cuda").manual_seed(131)
    x = torch.randn((4, 1000, cfg.d_model), device="cuda",
                    generator=gen).to(torch.bfloat16)
    c = moe.capacity(1000, e, k, cfg.moe_capacity_factor)
    run = lambda xx: moe.moe_ffn(xx, lp, n_experts=e, top_k=k,
                                 capacity_factor=cfg.moe_capacity_factor)
    with torch.no_grad():
        probs = moe.router_probs(x, lp.router)
        r = moe.route(probs, k, c)
        y, aux = run(x)
    host = host_routing(probs.cpu().numpy(), k, c)
    for key in ("idx", "keep", "slot"):
        if not np.array_equal(r[key].cpu().numpy(), host[key]):
            raise AssertionError(f"[moe layer] routing {key!r} differs "
                                 "from the host's")
    dropped = int((~r["keep"]).sum())
    log(f"[moe layer] C = {c}: routing idx, keep, slot equal to the "
        f"host's; {dropped} of {r['keep'].numel()} (token, expert) pairs "
        "dropped")

    sample = torch.randperm(n, generator=torch.Generator().manual_seed(7))
    sample = sample[:MOE_SAMPLE].to("cuda")
    xs = x.reshape(n, -1)[sample].float()
    idx = r["idx"].reshape(n, k)[sample]
    w = (r["gates"] * r["keep"]).reshape(n, k)[sample]
    want = torch.zeros_like(xs)
    with torch.no_grad():
        for ex in torch.unique(idx).tolist():
            rows, j = torch.nonzero(idx == ex, as_tuple=True)
            xr = xs[rows]
            h = (F.silu(xr @ lp.w_gate[ex].float())
                 * (xr @ lp.w_up[ex].float())) @ lp.w_down[ex].float()
            want.index_add_(0, rows, h * w[rows, j, None])
    got = y.reshape(n, -1)[sample].float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[moe layer] y on {MOE_SAMPLE} tokens against the float32 loop "
        f"over kept experts: max abs err {err} (|y| up to {scale}); aux "
        f"{float(aux)!r}")
    torch.testing.assert_close(got, want, atol=MOE_BAND * scale,
                               rtol=MOE_BAND)

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32,
                        device="cuda")
    xd = x[:, :1].contiguous()
    with torch.no_grad():
        times = {"prefill_ms": time_ms(torch, lambda: run(x), flush, 5),
                 "decode_ms": time_ms(torch, lambda: run(xd), flush, 10)}
    # a decode step's FFN reads every expert (capacity(1, 128, 8) = 8)
    w_bytes = 3 * e * cfg.d_model * cfg.moe_d_ff * 2
    times["decode_bound_ms"] = w_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"[moe layer] moe_ffn at (4, 1000, {cfg.d_model}) "
        f"{times['prefill_ms']:.3f} ms, at a decode step's (4, 1, "
        f"{cfg.d_model}) {times['decode_ms']:.3f} ms (reading the "
        f"{w_bytes} bytes of experts takes {times['decode_bound_ms']:.3f} "
        "ms at the card's rate)")
    return {"dropped": dropped, **times}


def slice_moe_serve(torch, wrappers, qk, ref) -> tuple:
    """Phase 13 (a) and (b): qwen3-moe-235b-a22b at full width and
    MOE_SERVE_LAYERS layers served through the launcher's engine on phase
    8's traffic, then the 2-layer kernel-vs-plain checks and the MoE layer
    against a plain MoE.  Returns the serving run's launch counts and the
    MoE layer's numbers."""
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import pool_nbytes

    cfg = dataclasses.replace(get(MOE_ARCH), n_layers=MOE_SERVE_LAYERS,
                              act_mode="none")
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    experts = 3 * e * d * f
    attn_p = 2 * d * cfg.n_heads * cfg.d_head + 2 * d * cfg.n_kv_heads * \
        cfg.d_head
    reckon = (cfg.n_layers * (2 * (experts + attn_p) + 4 * d * e)
              + 2 * 2 * cfg.vocab * d)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    torch.cuda.synchronize()
    log(f"[moe serve] {MOE_ARCH} at {cfg.n_layers} layers: reckoned "
        f"{experts} expert + {attn_p} attention bf16 parameters and a "
        f"{4 * d * e}-byte float32 router a layer, {2 * 2 * cfg.vocab * d} "
        f"bytes of embedding and head: {reckon} bytes; the model holds "
        f"{model_bytes(model)} bytes, built in {time.perf_counter() - t0:.1f}"
        f" s (peak {torch.cuda.max_memory_allocated()})")

    args = serve.parser().parse_args(MOE_SERVE_ARGV)
    engine, requests = serve.build_engine(args, model)
    pool_bytes = pool_nbytes(engine.pool)
    plain_calls = [0]
    with plain_attention_on_card(ref, plain_calls):
        out, launches, peak = counted_run(
            torch, wrappers, dict(planned(0, 0, 0), **MOE_SERVE_LAUNCHES),
            "moe serve", lambda: engine.run(requests))
    serve.report(args, engine, out)
    if plain_calls[0]:
        raise AssertionError("[moe serve] plain attention ran on the card")
    done = [r for r in out["results"] if r.status == "done"]
    if len(done) != 8 or any(r.tokens.shape != (32,) for r in done):
        raise AssertionError(f"[moe serve] {len(done)}/8 requests served")
    log(f"[moe serve] pool bytes {pool_bytes} layout "
        f"{engine.layout.pool_bytes}")
    if not pool_bytes == engine.layout.pool_bytes == MOE_SERVE_POOL_BYTES:
        raise AssertionError("[moe serve] pool bytes differ from the layout")
    log(f"[moe serve] TTFT mean {out['ttft_mean_ms']!r} ms, TPOT mean "
        f"{out['tpot_mean_ms']!r} ms, {out['tokens_per_sec']!r} tokens/s, "
        f"p50 {out['p50_latency_ms']!r} ms, p99 {out['p99_latency_ms']!r} "
        f"ms, wall {out['wall_s']!r} s, {out['decode_steps']} decode steps, "
        f"max_memory_allocated {peak} bytes")
    log(f"[moe serve] first request's tokens {done[0].tokens.tolist()}")
    del engine

    eng, _ = serve.build_engine(args, model, collect_logits=True)
    again = eng.run(requests)
    for a, b in zip(out["results"], again["results"]):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"[moe serve] request {a.rid}: tokens "
                                 "differ in the run collecting logits")
    if not all(np.isfinite(again["logits"][r.rid]).all() for r in done):
        raise AssertionError("[moe serve] non-finite logits")
    log("[moe serve] a run collecting logits: the same tokens, finite "
        "logits")
    del again

    # where a prefill group and a decode step go
    eng, _ = serve.build_engine(args, model, collect_logits=True)
    state, table, prefill_ms = admit_group(eng, requests)
    page_table = torch.as_tensor(table, device="cuda")
    steps = []
    for _ in range(3):
        state, ms = timed(torch, lambda: eng._step(page_table, state))
        eng.sched.tick()
        steps.append(ms)
    _, step_wall, step_busy = profiled(
        torch, lambda: eng._step(page_table, state), "moe decode step")
    for si in range(eng.max_batch):
        eng.sched.complete(si)
    for r in requests[:eng.max_batch]:
        eng.sched.submit(r)
    group = eng.sched.admit()
    profiled(torch, lambda: eng._admit_group(group, eng._init_state(),
                                             table),
             "moe prefill (4 x 1000 tokens)")
    log(f"[moe serve] unprofiled: prefill of a 4 x 1000 group "
        f"{prefill_ms:.3f} ms; decode steps {steps} ms")
    del eng, state

    # 2 layers of the same weights: prefill logits with the kernel against
    # the plain attention, and a paged decode step against decode_attend
    # over the plain-dequantized window (phase 8's bands)
    two = Model(dataclasses.replace(cfg, n_layers=2), dict(
        embed=model.embed.data, final_norm=model.final_norm.data,
        lm_head=model.lm_head.data,
        layers=[layer_tree(lp) for lp in model.layers[:2]]))
    prompts = torch.as_tensor(np.stack([r.prompt for r in requests[:4]]),
                              device="cuda")
    with_kernel, _ = two.prefill(prompts)
    two.impl = "torch"
    with_plain, _ = two.prefill(prompts)
    two.impl = "auto"
    err = float((with_kernel - with_plain).abs().max())
    log(f"[moe serve] 2 layers: prefill logits kernel vs plain attention: "
        f"max abs err {err} (logits up to {float(with_plain.abs().max())});"
        f" argmax equal "
        f"{torch.equal(with_kernel.argmax(-1), with_plain.argmax(-1))}")
    if err > 0.1:
        raise AssertionError(f"[moe serve] 2-layer logits differ by {err}")
    eng2 = serve.build_engine(args, two, collect_logits=True)[0]
    state, table, _ = admit_group(eng2, requests)
    err, scale, same = paged_against_window(
        torch, eng2, torch.as_tensor(table, device="cuda"), state, ref)
    log(f"[moe serve] 2 layers: a decode step's logits through the paged "
        f"read against the plain-dequantized window: max abs err {err} "
        f"(logits up to {scale}); argmax equal {same}")
    if err > 0.1:
        raise AssertionError(f"[moe serve] 2-layer decode logits differ by "
                             f"{err}")
    del two, eng2, state

    layer = check_moe_layer(torch, model)
    share = cfg.n_layers * layer["decode_ms"]
    log(f"[moe serve] moe_ffn of a decode step (CUDA events, gaps "
        f"between its launches included): {cfg.n_layers} x "
        f"{layer['decode_ms']:.3f} = {share:.3f} ms, {share / step_wall:.3f} "
        f"of the profiled step's wall ({step_wall:.3f} ms; device busy "
        f"{step_busy:.3f} ms)")
    del model
    torch.cuda.empty_cache()
    return launches, layer


def slice_moe_arctic(torch, wrappers) -> dict:
    """Phase 13 (c): arctic-480b at full width and ARCTIC_LAYERS layers
    (the dense FFN residual under ln3 before the experts) serving 2
    requests of 256 + 8 tokens: tokens served, finite logits, launches as
    planned.  Returns the launch counts."""
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models import Model

    cfg = dataclasses.replace(get("arctic-480b"), n_layers=ARCTIC_LAYERS,
                              act_mode="none")
    d, e = cfg.d_model, cfg.n_experts
    layer = 2 * (3 * e * d * cfg.moe_d_ff + 3 * d * cfg.d_ff
                 + 2 * d * cfg.n_heads * cfg.d_head
                 + 2 * d * cfg.n_kv_heads * cfg.d_head) + 4 * d * e
    t0 = time.perf_counter()
    model = Model(cfg)
    torch.cuda.synchronize()
    log(f"[arctic] reckoned {layer} bytes a layer (experts, dense "
        f"residual, attention, router), {2 * 2 * cfg.vocab * d} of "
        f"embedding and head; the model holds {model_bytes(model)} bytes, "
        f"built in {time.perf_counter() - t0:.1f} s")
    args = serve.parser().parse_args(ARCTIC_ARGV)
    engine, requests = serve.build_engine(args, model, collect_logits=True)
    pages = -(-(256 + 8 - 1) // 16)
    want = dict(planned(0, 0, 0), flash_attention=ARCTIC_LAYERS,
                quant_pack=(1 + 7) * 2 * ARCTIC_LAYERS,
                dequant_unpack=7 * ARCTIC_LAYERS * pages)
    out, launches, peak = counted_run(torch, wrappers, want, "arctic serve",
                                      lambda: engine.run(requests))
    serve.report(args, engine, out)
    done = [r for r in out["results"] if r.status == "done"]
    if len(done) != 2 or any(r.tokens.shape != (8,) for r in done):
        raise AssertionError(f"[arctic] {len(done)}/2 requests served")
    if not all(np.isfinite(out["logits"][r.rid]).all() for r in done):
        raise AssertionError("[arctic] non-finite logits")
    log(f"[arctic] 2 requests served, finite logits; tokens "
        f"{[r.tokens.tolist() for r in done]}; max_memory_allocated {peak}")
    del engine, model
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def lm_depth(train, n_layers: int):
    """Inside: the launcher's LM config cut to ``n_layers`` layers."""
    whole = train.lm_config
    train.lm_config = lambda args: dataclasses.replace(whole(args),
                                                       n_layers=n_layers)
    try:
        yield
    finally:
        train.lm_config = whole


@contextlib.contextmanager
def aux_taps(Model, out: list):
    """Inside: each ``Model.hidden_states`` call appends its aux loss."""
    whole = Model.hidden_states

    def hidden_states(self, *a, **kw):
        h, aux = whole(self, *a, **kw)
        out.append(aux.detach())
        return h, aux

    Model.hidden_states = hidden_states
    try:
        yield
    finally:
        Model.hidden_states = whole


def slice_moe_train(torch, wrappers) -> dict:
    """Phase 13 (d): MoE LM training through the launcher, qwen3-moe at
    full width and 1 layer, remat, 8-bit AdamW, B 8 x 512 in grad_accum 8
    micro-batches, 5 steps: a finite loss and aux every step, a nonzero
    router gradient, the 8-bit moments' launches as planned.  Returns the
    launch counts."""
    from repro_torch.configs import get
    from repro_torch.launch import train
    from repro_torch.models import Model

    cfg = dataclasses.replace(get(MOE_ARCH), n_layers=1)
    n = cfg.param_count()
    log(f"[moe lm] reckoning: {n} parameters; bf16 weights {2 * n}, float32 "
        f"grad sums {4 * n} (and as much again while they are divided and "
        f"clipped), bf16 micro-batch grads {2 * n}; float32 moments would "
        f"be {8 * n}, 8-bit ones are {2 * n + 2 * 8 * n // 256}")
    n_leaves = 15     # embed, final_norm, lm_head, and 12 of the layer
    steps = 5
    auxes = []
    with lm_depth(train, 1), aux_taps(Model, auxes):
        (res, _), counts, peak = counted_run(
            torch, wrappers, planned(0, 0, steps, moments=2 * n_leaves),
            "moe lm", lambda: launcher(train, MOE_LM_ARGV, train.lm_main))
    model = res["model"]
    if len(list(model.parameters())) != n_leaves:
        raise AssertionError("[moe lm] unexpected parameter count")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    aux = torch.stack(auxes).reshape(steps, cfg.grad_accum).cpu()
    log(f"[moe lm] losses {losses}; aux a step (mean of its micro-batches) "
        f"{aux.mean(1).tolist()}; step s {[h['dt'] for h in hist]}; "
        f"max_memory_allocated {peak}")
    if not (all(map(math.isfinite, losses)) and torch.isfinite(aux).all()):
        raise AssertionError(f"[moe lm] losses {losses}, aux {aux}")
    tokens = res["make_batch"](steps)["tokens"][:1]
    router = model.layers[0].moe.router
    (g,) = torch.autograd.grad(model.loss(tokens, vocab_chunk=cfg.vocab_chunk),
                               [router])
    g_norm = float(g.norm())
    log(f"[moe lm] router gradient norm {g_norm!r} on a 1 x 512 micro-batch")
    if not (math.isfinite(g_norm) and g_norm > 0):
        raise AssertionError("[moe lm] no router gradient")
    del res, model, g
    torch.cuda.empty_cache()
    return counts


# ------------------------------- phase 14: the SSM, hybrid and enc-dec families
#: Seconds phase 14 may take in all.
PHASE14_LIMIT_S = 120.0
MAMBA, ZAMBA, SEAMLESS = "mamba2-780m", "zamba2-1.2b", "seamless-m4t-large-v2"
#: Phase 8's traffic through the legacy loop: 8 requests, 4 a batch, a
#: prompt of 1024 tokens (a multiple of ssm_chunk 128) and 32 generated.
LEGACY_ARGV = ["--requests", "8", "--max-batch", "4", "--prompt-len", "1024",
               "--gen-len", "32", "--device", "cuda"]
LEGACY_BATCHES, LEGACY_STEPS = 2, 31
#: Flash launches of each family's run: none for the attention-free
#: mamba2; the hybrid's shared block at its 6 sites a prefill batch; the
#: enc-dec's 24 encoder layers a batch (non-causal) and its 24
#: cross-attentions a decode step (Sq 1 over the 1024 encoder rows).
LEGACY_FLASH = {MAMBA: 0, ZAMBA: LEGACY_BATCHES * 6,
                SEAMLESS: LEGACY_BATCHES * 24
                + LEGACY_BATCHES * LEGACY_STEPS * 24}
#: The flash calls this slice adds, (BH, Sq, Skv, Dh, causal): the
#: encoder's (4 prompts x 16 heads), a decode step's cross-attention, the
#: hybrid's shared block (4 prompts x 32 heads of 128).
FAMILY_FLASH = (("encoder", 64, 1024, 1024, 64, False),
                ("cross decode", 64, 1, 1024, 64, False),
                ("shared block", 128, 1024, 1024, 128, True))
#: The INT2 layer stash of act-mode training: B x S x d_model / 256 blocks
#: (mamba2 B 4 x 2048 x 1536, zamba2 B 2 x 2048 x 2048).
FAMILY_STASH = (("mamba2 stash", 4 * 2048 * 1536 // 256),
                ("zamba2 stash", 2 * 2048 * 2048 // 256))
#: The SSD scan against a float64 recurrence: max abs error within this
#: share of the largest |y| (and of the largest |state|).
SSD_BAND = 1e-3
#: Prefill against prefill + teacher-forced decode (bf16 activations):
#: logits within phase 8's 0.1; conv cache and SSD state within this share
#: of their largest magnitude.
STATE_BAND = 2.0 ** -5
PREFIX_TOKENS = 896
FAMILY_LM = {
    MAMBA: ["--arch", MAMBA, "--batch", "4", "--seq", "2048", "--lr",
            str(LM_LR), "--act-mode", "act", "--steps", "5", "--device",
            "cuda"],
    ZAMBA: ["--arch", ZAMBA, "--batch", "2", "--seq", "2048", "--lr",
            str(LM_LR), "--act-mode", "act", "--steps", "2", "--device",
            "cuda"],
    SEAMLESS: ["--arch", SEAMLESS, "--batch", "2", "--seq", "1024", "--lr",
               str(LM_LR), "--act-mode", "remat", "--steps", "2",
               "--device", "cuda"]}


def check_flash_case(torch, fa, ref, flush, gen, bh, sq, skv, dh,
                     causal) -> dict:
    """One bf16 flash call of the families' path against its plain
    version (within one bf16 ulp, 1e-3 absolute near zero), timed beside
    it, float32 SDPA (library_ms), bf16 SDPA (context) and the bound: 4 *
    Dh flops a kept pair at the bf16 tensor-core peak, or the bytes."""
    import torch.nn.functional as F

    q = torch.randn((bh, sq, dh), device="cuda", generator=gen).bfloat16()
    k = torch.randn((bh, skv, dh), device="cuda", generator=gen).bfloat16()
    v = torch.randn((bh, skv, dh), device="cuda", generator=gen).bfloat16()
    kw = dict(causal=causal, scale_q=True)
    got = fa.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                               rtol=2.0 ** -7)
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    nbytes = 2 * bh * (2 * sq + 2 * skv) * dh
    bnd = bound(nbytes, 4 * bh * dh * pairs, PEAK_BF16_OPS_PER_S)
    q4, k4, v4 = (t.float()[None] for t in (q, k, v))
    row = dict(
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), flush),
        plain_ms=time_ms(torch, lambda: ref.flash_attention(q, k, v, **kw),
                         flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), flush),
        sdpa_bf16_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal), flush),
        bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err,
        mismatch_share=float((got != want).float().mean()),
        flops=4 * bh * dh * pairs, bytes=nbytes)
    return row


def check_family_shapes(torch, fa, qk, ref) -> dict:
    """Phase 14's kernels at the families' shapes against their plain
    versions, timed: FAMILY_FLASH's three bf16 flash calls and the INT2
    stash at FAMILY_STASH's block counts."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = {}
    for tag, bh, sq, skv, dh, causal in FAMILY_FLASH:
        row = check_flash_case(torch, fa, ref, flush, gen, bh, sq, skv, dh,
                               causal)
        tag = f"{tag} ({bh}, {sq}, {skv}, {dh}) causal={causal}"
        log(f"flash_attention {tag} bf16: {row}")
        rows[("flash_attention", tag)] = row
    for tag, n_blocks in FAMILY_STASH:
        shape, q, d = quant_case(torch, qk, ref, n_blocks, 256, 2, None,
                                 flush, gen)
        rows[("quant_pack", f"{tag} {shape}")] = q
        rows[("dequant_unpack", f"{tag} {shape}")] = d
    del flush
    torch.cuda.empty_cache()
    return rows


def naive_ssd64(xh, dt, a_neg, bmat, cmat):
    """The token-by-token SSD recurrence (the reference test's
    ``naive_ssd``) in float64 numpy on the host, the state updated in
    place: (y (B,S,H,P), final state (B,H,P,N))."""
    x, dt, a, bm, cm = (t.detach().double().cpu().numpy()
                        for t in (xh, dt, a_neg, bmat, cmat))
    b, s, h, p = x.shape
    decay = np.exp(dt * a)                                  # (B,S,H)
    dx = dt[..., None] * x                                  # (B,S,H,P)
    st = np.zeros((b, h, p, bm.shape[-1]))
    upd = np.empty_like(st)
    ys = np.empty((b, s, h, p))
    for t in range(s):
        st *= decay[:, t, :, None, None]
        np.multiply(dx[:, t, :, :, None], bm[:, t, None, None, :], out=upd)
        st += upd
        ys[:, t] = (st @ cm[:, t, None, :, None])[..., 0]
    return ys, st


def check_ssd(torch, model, prompt) -> dict:
    """Phase 14 (a): one layer's real SSD inputs (layer 0 of ``model`` on
    ``prompt``, (1, 1024, H, P), N) through ``ssd_chunked`` on the card
    against the float64 recurrence on the host, within SSD_BAND."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import rmsnorm

    cfg, lp = model.cfg, model.layers[0]
    with torch.no_grad():
        x = rmsnorm(model.embed[prompt], lp.ln)
        _, xi, bmat, cmat, dt = ssm._project(x, lp.mixer, cfg)
        xh = xi.reshape(*xi.shape[:2], -1, cfg.ssm_headdim)
        a_neg = -torch.exp(lp.mixer.a_log.float())
        y, st = ssm.ssd_chunked(xh, dt, a_neg, bmat, cmat,
                                chunk=cfg.ssm_chunk, return_state=True)
    t0 = time.perf_counter()
    y64, st64 = naive_ssd64(xh, dt, a_neg, bmat, cmat)
    host_s = time.perf_counter() - t0
    out = {}
    for what, got, want in (("y", y, y64), ("state", st, st64)):
        err = float(np.abs(got.double().cpu().numpy() - want).max())
        scale = float(np.abs(want).max())
        out[what] = (err, scale)
        if not err <= SSD_BAND * scale:
            raise AssertionError(f"[ssd] {what}: max abs err {err} over "
                                 f"{SSD_BAND} x {scale}")
    log(f"[ssd] layer 0's inputs {tuple(xh.shape)} N {bmat.shape[-1]} "
        f"chunk {cfg.ssm_chunk}: y max abs err {out['y'][0]} (|y| up to "
        f"{out['y'][1]}), final state {out['state'][0]} (up to "
        f"{out['state'][1]}) against the float64 recurrence ({host_s:.1f} s "
        f"on the host); band {SSD_BAND} of the largest")
    return out


def sub_model(torch, model, **cut):
    """The model's first layers (and encoder layers) at full width, sharing
    its weights: ``cut`` replaces config fields (``n_layers``, ...)."""
    from repro_torch.models import Model

    cfg = dataclasses.replace(model.cfg, **cut)
    tree = dict(embed=model.embed.data, final_norm=model.final_norm.data,
                lm_head=model.lm_head.data,
                layers=[layer_tree(lp)
                        for lp in model.layers[:cfg.n_layers]])
    if cfg.family == "hybrid":
        tree["shared_attn"] = layer_tree(model.shared_attn)
    if cfg.family == "encdec":
        tree["enc_layers"] = [layer_tree(lp) for lp in
                              model.enc_layers[:cfg.encoder_layers]]
        tree["enc_norm"] = model.enc_norm.data
    return Model(cfg, tree)


def check_prefill_decode(torch, model, prompts) -> dict:
    """Phase 14 (a): on the first 2 layers, ``prefill`` of the whole
    prompts against ``prefill`` of their first PREFIX_TOKENS and one
    teacher-forced ``decode_step`` a token after: the last logits within
    0.1, the conv cache and the SSD state within STATE_BAND of their
    largest magnitude."""
    two = sub_model(torch, model, n_layers=2)
    whole, cw = two.prefill(prompts)
    part, cp = two.prefill(prompts[:, :PREFIX_TOKENS])
    for t in range(PREFIX_TOKENS, prompts.shape[1]):
        logits, cp = two.decode_step(cp, prompts[:, t:t + 1])
    errs = {"logits": (float((logits[:, 0] - whole).abs().max()),
                       float(whole.abs().max()))}
    for key in ("conv", "ssd"):
        errs[key] = (float((cp[key].float() - cw[key].float()).abs().max()),
                     float(cw[key].float().abs().max()))
    log(f"[{model.cfg.name} 2 layers] prefill({prompts.shape[1]}) against "
        f"prefill({PREFIX_TOKENS}) + {prompts.shape[1] - PREFIX_TOKENS} "
        f"decode steps: max abs err (largest |value|) {errs}; argmax equal "
        f"{torch.equal(logits[:, 0].argmax(-1), whole.argmax(-1))}")
    if errs["logits"][0] > 0.1 or any(
            errs[k][0] > STATE_BAND * errs[k][1] for k in ("conv", "ssd")):
        raise AssertionError(f"[{model.cfg.name}] prefill and decode "
                             f"disagree: {errs}")
    return errs


def legacy_serve(torch, wrappers, model, name: str,
                 repeat: bool = False) -> dict:
    """A family served through the launcher's legacy loop on LEGACY_ARGV's
    traffic, with its launches as planned and no plain attention on the
    card; with ``repeat`` a second run must give the same tokens.  Logs
    TTFT (a batch's prefill span), decode tokens/s and the peak; returns
    them and the launch counts."""
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.obs.trace import Tracer, set_tracer

    args = serve.parser().parse_args(["--arch", name] + LEGACY_ARGV)
    want = dict(planned(0, 0, 0), flash_attention=LEGACY_FLASH[name])
    tracer, calls = Tracer(), [0]
    prev = set_tracer(tracer)
    try:
        with plain_attention_on_card(ref, calls):
            rows, launches, peak = counted_run(
                torch, wrappers, want, f"{name} serve",
                lambda: serve._legacy_loop(model, args))
    finally:
        set_tracer(prev)
    if calls[0]:
        raise AssertionError(f"[{name} serve] plain attention ran on the "
                             "card")
    if len(rows) != 8 or any(r.shape != (32,) for r in rows):
        raise AssertionError(f"[{name} serve] {len(rows)}/8 requests served")
    spans = collections.defaultdict(list)
    for sp in tracer.spans:
        spans[sp.name].append(sp.dur)
    out = {"ttft_ms": [d * 1e3 for d in spans["serve/prefill"]],
           "decode_s": spans["serve/decode"],
           "tokens_per_s": 8 * LEGACY_STEPS / sum(spans["serve/decode"]),
           "peak": peak, "launches": launches}
    log(f"[{name} serve] 8 requests of 1024 + 32 tokens: TTFT (a batch's "
        f"prefill) {out['ttft_ms']} ms, decode {out['decode_s']} s a batch, "
        f"{out['tokens_per_s']!r} tokens/s, max_memory_allocated {peak}; "
        f"first tokens {rows[0].tolist()}")
    if repeat:
        again = serve._legacy_loop(model, args)
        if not all(np.array_equal(a, b) for a, b in zip(rows, again)):
            raise AssertionError(f"[{name} serve] a second run gives other "
                                 "tokens")
        log(f"[{name} serve] a second run: the same tokens")
    return out


def profile_decode(torch, model, name: str) -> tuple:
    """One decode step of a 4-request batch after a 1024-token prefill,
    profiled (device time by op, idle share); returns (wall ms, busy ms,
    the cache)."""
    from repro_torch.data import batch_for_step

    prompts = torch.as_tensor(batch_for_step(model.cfg.vocab, 4, 1024,
                                             step=0, seed=11), device="cuda")
    kw = {}
    if model.cfg.family == "encdec":
        kw["enc_embeds"] = torch.randn(
            (4, 1024, model.cfg.d_model), generator=torch.Generator(
            ).manual_seed(0)).to("cuda", torch.bfloat16)
    logits, cache = model.prefill(prompts, max_seq=1056, **kw)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    model.decode_step(cache, tok)
    _, wall, busy = profiled(torch, lambda: model.decode_step(cache, tok),
                             f"{name} decode step (4 slots)")
    return wall, busy, cache, tok


def slice_family_serve(torch, wrappers) -> collections.Counter:
    """Phase 14 (a)-(c): mamba2-780m, zamba2-1.2b and seamless-m4t-large-
    v2 at full width and depth served through the legacy loop, with each
    family's checks (see the module docstring)."""
    from repro_torch.configs import get
    from repro_torch.data import batch_for_step
    from repro_torch.models import Model
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rmsnorm

    total = collections.Counter()
    for name in (MAMBA, ZAMBA, SEAMLESS):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get(name), act_mode="none")
        model = Model(cfg)
        torch.cuda.synchronize()
        log(f"[{name}] {cfg.n_layers} layers"
            + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers
               else "") + f" at d_model {cfg.d_model}: "
            f"{cfg.param_count()} parameters (param_count), the model holds "
            f"{model_bytes(model)} bytes, built in "
            f"{time.perf_counter() - t0:.1f} s")
        served = legacy_serve(torch, wrappers, model, name,
                              repeat=name == MAMBA)
        total.update(served["launches"])
        prompts = torch.as_tensor(batch_for_step(cfg.vocab, 2, 1024, step=0,
                                                 seed=11), device="cuda")
        if name == MAMBA:
            check_ssd(torch, model, prompts[:1])
            check_prefill_decode(torch, model, prompts)
        elif name == ZAMBA:
            three = sub_model(torch, model, n_layers=3)
            if three.cfg.shared_attn_sites() != [1]:
                raise AssertionError("3-layer hybrid sites")
            with_kernel, _ = three.prefill(prompts)
            three.impl = "torch"
            with_plain, _ = three.prefill(prompts)
            err = float((with_kernel - with_plain).abs().max())
            log(f"[{name} 3 layers, shared block at [1]] prefill logits "
                f"kernel vs plain attention: max abs err {err} (logits up "
                f"to {float(with_plain.abs().max())})")
            if err > 0.1:
                raise AssertionError(f"[{name}] 3-layer logits differ by "
                                     f"{err}")
            del three
        else:
            two = sub_model(torch, model, n_layers=2, encoder_layers=2)
            enc = torch.randn((2, 1024, cfg.d_model), generator=torch
                              .Generator().manual_seed(0)).to("cuda",
                                                              torch.bfloat16)
            first = prompts[:, -1:]
            res = {}
            for impl in ("auto", "torch"):
                two.impl = impl
                _, cache = two.prefill(prompts, enc_embeds=enc)
                logits, _ = two.decode_step(cache, first)
                res[impl] = (cache["enc"].float(), logits)
            errs = [float((a - b).abs().max())
                    for a, b in zip(res["auto"], res["torch"])]
            scale = float(res["torch"][0].abs().max())
            log(f"[{name} 2 + 2 layers] kernel vs plain attention: encoder "
                f"output max abs err {errs[0]} (up to {scale}), a decode "
                f"step's logits {errs[1]}")
            if errs[0] > 2.0 ** -6 * scale or errs[1] > 0.1:
                raise AssertionError(f"[{name}] 2 + 2 layers differ: {errs}")
            del two, res
        wall, busy, cache, tok = profile_decode(torch, model, name)
        if name == SEAMLESS:
            # the step's cross-attentions alone, timed with CUDA events
            flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32,
                                device="cuda")
            lp = model.layers[0]
            h = model.embed[tok]

            def xattn():
                with torch.no_grad():
                    for _ in range(cfg.n_layers):
                        attn.cross_attention_block(
                            rmsnorm(h, lp.ln_x), lp.xattn, cfg, cache["enc"],
                            online=True)

            ms = time_ms(torch, xattn, flush, 5)
            log(f"[{name}] a decode step's {cfg.n_layers} cross-attentions "
                f"(K/V projected anew, flash at Sq 1 over 1024 keys): "
                f"{ms:.3f} ms of the profiled step's {wall:.3f} ms wall "
                f"({ms / wall:.3f}; device busy {busy:.3f} ms)")
            del flush
        del model, cache
        torch.cuda.empty_cache()
        log(f"[{name}] phase 14 serving part: "
            f"{time.perf_counter() - t0:.1f} s")
    return total


def time_ssd(torch, cfg, batch: int, seq: int) -> dict:
    """``ssd_chunked`` at one Mamba-2 layer's training shape, forward alone
    and forward + backward, from random inputs (CUDA events, cold L2)."""
    from repro_torch.models import ssm

    _, n_heads = ssm.ssm_dims(cfg)
    gen = torch.Generator(device="cuda").manual_seed(141)
    mk = lambda *shape: torch.randn(shape, device="cuda", generator=gen)
    xh = mk(batch, seq, n_heads, cfg.ssm_headdim).requires_grad_()
    dt = torch.nn.functional.softplus(mk(batch, seq, n_heads)).requires_grad_()
    bm = mk(batch, seq, cfg.ssm_state).requires_grad_()
    cm = mk(batch, seq, cfg.ssm_state).requires_grad_()
    a_neg = -torch.ones(n_heads, device="cuda")
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")

    def fwd():
        with torch.no_grad():
            ssm.ssd_chunked(xh, dt, a_neg, bm, cm, chunk=cfg.ssm_chunk)

    def fwd_bwd():
        y, _ = ssm.ssd_chunked(xh, dt, a_neg, bm, cm, chunk=cfg.ssm_chunk)
        torch.autograd.grad(y.sum(), (xh, dt, bm, cm))

    out = {"fwd_ms": time_ms(torch, fwd, flush, 5),
           "fwd_bwd_ms": time_ms(torch, fwd_bwd, flush, 5)}
    del flush, xh, dt, bm, cm
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def grad_taps(steps, out: list):
    """Inside: each AdamW update of ``launch.steps`` appends whether every
    gradient it was handed is finite (a device bool, read later)."""
    whole = steps.adamw_update

    def update(grads, *a, **kw):
        import torch

        out.append(torch.stack([torch.isfinite(g).all() for g in grads])
                   .all())
        return whole(grads, *a, **kw)

    steps.adamw_update = update
    try:
        yield
    finally:
        steps.adamw_update = whole


def slice_family_train(torch, wrappers) -> collections.Counter:
    """Phase 14 (d): the three families trained through the launcher at
    full width and depth (FAMILY_LM), float32 moments: finite losses and
    gradients every step, the INT2 stash's launches a Mamba-2 layer and
    step under ``act``, mamba2's loss falling; then mamba2 at
    LM_LAYERS_SHORT layers under none / remat / act (residual bytes act <
    remat < none)."""
    from repro_torch.configs import get
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch import train

    total = collections.Counter()
    for name, argv in FAMILY_LM.items():
        t0 = time.perf_counter()
        cfg = get(name)
        args = train.parser().parse_args(argv)
        n = cfg.param_count()
        toks = args.batch * args.seq
        logits = 2 * args.batch * min(cfg.vocab_chunk, args.seq) \
            * cfg.vocab * 4
        stash = cfg.n_layers * (toks * cfg.d_model // 4
                                + toks * cfg.d_model // 256 * 8)
        log(f"[{name} lm] reckoning: {n} parameters, bf16 weights and "
            f"grads {2 * n} + {2 * n} bytes, float32 AdamW moments {8 * n}; "
            f"largest transient a loss chunk's float32 logits and their "
            f"gradient {logits}" + (f"; INT2 stashes {stash}"
                                    if args.act_mode == "act" else ""))
        n_stash = cfg.n_layers if args.act_mode == "act" else 0
        want = dict(planned(0, 0, 0), quant_pack=n_stash * args.steps,
                    dequant_unpack=n_stash * args.steps)
        finite = []
        with grad_taps(lsteps, finite):
            (res, _), counts, peak = counted_run(
                torch, wrappers, want, f"{name} lm",
                lambda: launcher(train, argv, train.lm_main))
        total.update(counts)
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        grads_ok = [bool(f) for f in finite]
        log(f"[{name} lm] {args.act_mode} B {args.batch} x {args.seq}: "
            f"losses {losses}; gradients finite {grads_ok}; step s "
            f"{[h['dt'] for h in hist]}; max_memory_allocated {peak}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not (all(map(math.isfinite, losses)) and all(grads_ok)
                and len(grads_ok) == args.steps):
            raise AssertionError(f"[{name} lm] losses {losses}, gradients "
                                 f"finite {grads_ok}")
        if name == MAMBA:
            if not losses[-1] < losses[0]:
                raise AssertionError(f"[{name} lm] loss does not fall: "
                                     f"{losses}")
            batch = res["make_batch"](args.steps)
            profile_call(torch, lambda: float(res["step_fn"](
                (res["model"], res["opt_state"]), batch)[1]["loss"]),
                f"lm step ({name}, 48 layers, act, B 4 x 2048)", top=20)
            log(f"[{name} lm] with the profiled step: "
                f"{time.perf_counter() - t0:.1f} s")
            ssd = time_ssd(torch, cfg, args.batch, args.seq)
            share = cfg.n_layers * (ssd["fwd_ms"] + ssd["fwd_bwd_ms"]) \
                / (1e3 * statistics.median(h["dt"] for h in hist[1:]))
            log(f"[{name} lm] the SSD scan of a layer at B {args.batch} x "
                f"{args.seq} (CUDA events): forward {ssd['fwd_ms']:.3f} ms, "
                f"forward + backward {ssd['fwd_bwd_ms']:.3f} ms; a step "
                f"runs each once a layer (act: the forward, then its "
                f"recomputation and backward): {share:.3f} of the median "
                f"step")
        del res
        torch.cuda.empty_cache()
        log(f"[{name} lm] phase 14 training part: "
            f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    runs = {}
    for mode in ("none", "remat", "act"):
        runs[mode] = lm_short(torch, train, mode, argv=FAMILY_LM[MAMBA])
        del runs[mode]["model"]
        torch.cuda.empty_cache()
    order = [runs[m]["residual"] for m in ("act", "remat", "none")]
    log(f"[{MAMBA} {LM_LAYERS_SHORT} layers] peak / residual bytes / step "
        "ms: " + "; ".join(f"{m} {r['peak']} / {r['residual']} / {r['ms']}"
                           for m, r in runs.items()))
    if not order[0] < order[1] < order[2]:
        raise AssertionError(f"[{MAMBA} {LM_LAYERS_SHORT} layers] residual "
                             f"bytes act < remat < none fails: {order}")
    log(f"[{MAMBA} {LM_LAYERS_SHORT} layers] phase 14 part: "
        f"{time.perf_counter() - t0:.1f} s")
    return total


# ------------------------------- phase 15: the static checker and the examples
#: Seconds phase 15 may take in all.
PHASE15_LIMIT_S = 120.0
#: The stash placements phase 15 (b) audits on phase 4's graph (None: the
#: per-tensor stash).
AUDIT_PLACEMENTS = (None, "device", "pinned-paged")
#: Bytes the caching allocator may add to one saved tensor (its rounding).
ALLOC_SLACK = 512
#: The quant kernels at the GNN example's G = 32 (EXACT's per-row blocks)
#: and G = 2048 (G/R 64) rows at ``--scale 1.0``: the RP-8 stashes of layer
#: 0 (169,343 x 32) and layers 1-2 (169,343 x 64), INT2 uniform; a block of
#: 2048 spans 64 rows of layer 0's stash and the last one is ragged.
EXAMPLE_QUANT = ((N_NODES, 32), (2 * N_NODES, 32),
                 (-(-N_NODES * 32 // 2048), 2048),
                 (-(-N_NODES * 64 // 2048), 2048))
EXAMPLE_GNN_ARGV = ["--scale", "1.0", "--epochs", "5", "--batches", "4",
                    "--device", "cuda"]
EXAMPLE_SERVE_ARCHS = ("zamba2-1.2b", "seamless-m4t-large-v2")
EXAMPLE_LM_ARGV = ["--steps", "10", "--device", "cuda"]
ROOT = Path(__file__).resolve().parent


def smoke_launches() -> list:
    """Every quant, RP and fused shape this script launches on the card, as
    :class:`repro_torch.staticcheck.kernel_contracts.Launch` rows (phase 15
    and the CPU tests hold them to the kernel contracts)."""
    from repro_torch.core.variance import optimize_levels
    from repro_torch.staticcheck.kernel_contracts import Launch

    vm32, vm256 = optimize_levels(32, 2), optimize_levels(256, 2)
    tables = {"flickr": optimize_levels(125 // 8, 2),
              "vm8": optimize_levels(256 // 8, 8)}
    quant = [(n, 256, 2, lv) for n in (21_168, 42_336) for lv in (None, vm32)]
    quant += [(n, 256, 2, vm32) for n in BATCH_QUANT_BLOCKS]
    quant += [(n, G, bits, tables[what] if vm else None)
              for what, n, G, bits, vm in EXTRA_QUANT]
    for nbt in (KV_NBT, MOE_KV_NBT):
        quant += [(n_tok * nbt, KV_G, KV_BITS, None)
                  for n_tok in (KV_PREFILL_TOKENS, 4, KV_PAGE_TOKENS)]
    quant += [(n_tok * KV_NBT, KV_G, KV_BITS, None)
              for n_tok in (2 * 1008, 2, 2 * 2 * 16)]
    quant += [(n, 256, 8, None) for n in (MOE_MOMENT_PLAIN_BLOCKS,
                                          MOE_MOMENT_BLOCKS)]
    quant += [(n, 256, 2, None) for _, n in FAMILY_STASH]
    quant += [(n, G, 2, None) for n, G in EXAMPLE_QUANT]
    out = [Launch("quant", n, G, G, bits, G, lv) for n, G, bits, lv in quant]
    out += [Launch("fused", rows, d, n, 2, 256, vm256)
            for rows in (N_NODES, BATCH_NODES) for d, n in FUSED_LAYERS]
    out += [Launch("rp", rows, d, d // 8, 2, 256, vm32, 8)
            for rows in RP_ROWS for d in (256, 512)]
    return out


def matrix_planned() -> dict:
    """Launches of the checker's plan matrix on the card, one forward and
    one backward a case: the quant pair (and RP / IRP) of each unfused
    compressed layer, the fused pair of each fused one."""
    from repro_torch.staticcheck.kernel_contracts import matrix_launches

    want = dict(planned(0, 0, 0))
    names = {"quant": ("quant_pack", "dequant_unpack"),
             "rp": ("rp_project", "irp_project"),
             "fused": ("matmul_quant", "dequant_matmul")}
    for launch in matrix_launches():
        for name in names[launch.kind]:
            want[name] += 1
    return want


def slice_check_matrix(torch, wrappers) -> collections.Counter:
    """Phase 15 (a): ``python -m repro_torch.staticcheck --ci --no-cache
    --device cuda`` in a subprocess must exit 0 with no finding over the
    34 cases (the host placements on page-locked memory); then the same
    audit in this process, counted: launches as planned, every case clean
    and its ledger equal to the memory report."""
    import os

    from repro_torch.staticcheck import kernel_contracts, saved_audit

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.staticcheck", "--ci",
         "--no-cache", "--device", "cuda"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    log(proc.stdout.strip())
    if proc.stderr.strip():
        log(proc.stderr.strip())
    log(f"[check] staticcheck --ci --device cuda: exit {proc.returncode} "
        f"in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or "OK: no new findings (0 baselined)" \
            not in proc.stdout or proc.stdout.count(": ledger ") != 34:
        raise AssertionError("[check] the static checker did not pass on "
                             "the card")
    results, counts, _ = counted_run(
        torch, wrappers, matrix_planned(), "check matrix",
        lambda: saved_audit.run(device="cuda"))
    for r in results:
        if r.findings or r.ledger_bytes != r.report_bytes:
            raise AssertionError(f"[check] {r.key}: {r.to_json()}")
    log(f"[check] {len(results)} cases audited on the card in this process: "
        "no finding, every ledger equal to activation_memory_report")
    bad = kernel_contracts.check_launches(smoke_launches())
    log(f"[check] kernel contracts over this script's "
        f"{len(smoke_launches())} launch shapes: {len(bad)} finding(s)")
    if bad:
        raise AssertionError(f"[check] {[f.render() for f in bad]}")
    return collections.Counter(counts)


def requested_bytes(torch) -> int:
    """Bytes the caching allocator holds for live tensors, as requested
    (``memory_allocated`` also counts each block's rounding, and a large
    block's unsplit tail of up to 1 MB)."""
    return int(torch.cuda.memory_stats()["requested_bytes.all.current"])


def settle(torch) -> None:
    """The card idle and the allocator's deferred frees done: a tensor
    freed while a side stream still used it (``record_stream``, the host
    placements' copies) leaves ``memory_allocated`` at once but
    ``requested_bytes`` only when the allocator processes its events,
    which ``empty_cache`` does."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def audited_forward(torch, setup, what: str, ledger: int, params) -> dict:
    """Phase 15 (b)'s measure of one forward: the saved-tensor audit with
    no finding, its ledger equal to ``ledger``, the allocator's growth in
    requested bytes over the forward, less the logits, within ALLOC_SLACK
    a stash tensor of the saved tensors' device bytes (none for the host
    placements), then one backward draining the host store.  The growth
    of ``memory_allocated`` is logged beside it: it counts whole blocks.
    An unmeasured forward and backward run first."""
    from repro_torch.offload.engine import host_store_bytes
    from repro_torch.staticcheck import saved_audit

    import gc

    forward, inputs, splan, mechanism = setup
    # one unmeasured step first: a library's workspace (cuBLAS keeps 32 MiB
    # a stream) is allocated on its first use and kept
    out = forward()
    torch.autograd.grad(out, list(params), torch.ones_like(out))
    del out
    # earlier garbage freed first, and no collection inside the measure
    gc.collect()
    gc.disable()
    settle(torch)
    host0 = host_store_bytes()
    alloc0, req0 = torch.cuda.memory_allocated(), requested_bytes(torch)
    fwd = saved_audit.audit_forward(forward, inputs, splan, mechanism, what)
    settle(torch)
    logits = fwd.out.numel() * fwd.out.element_size()
    grown = requested_bytes(torch) - req0 - logits
    grown_alloc = torch.cuda.memory_allocated() - alloc0 - logits
    gc.enable()
    slack = ALLOC_SLACK * len(saved_audit.expected_residuals(splan,
                                                             "tensor"))
    row = {"ledger": fwd.ledger_bytes, "want": ledger,
           "saved_tensors": fwd.n_saved, "device_bytes": fwd.device_bytes,
           "requested_growth": grown, "allocated_growth": grown_alloc,
           "slack": slack, "host_store": host_store_bytes() - host0,
           "findings": [f.render() for f in fwd.findings]}
    findings = fwd.findings + saved_audit.drain(fwd, params, what, host0)
    row["host_store_after_backward"] = host_store_bytes() - host0
    log(f"[check {what}] {row}")
    host = mechanism in ("pageable", "pinned")
    if (findings or fwd.ledger_bytes != ledger
            or abs(grown - fwd.device_bytes) > slack
            or (host and (fwd.device_bytes or grown > slack))):
        raise AssertionError(f"[check {what}] the audit does not hold: {row}")
    return row


def slice_check_full(torch, g, cfg, model) -> None:
    """Phase 15 (b): the saved-tensor audit at phase 4's geometry (the
    full arxiv-like graph, SAGE (256, 256), INT2 G = 256, RP 8, VM) under
    AUDIT_PLACEMENTS, and the mesh's per-op forward on one rank over the
    whole graph as one partition."""
    from repro_torch.engine.plan import StashPolicy
    from repro_torch.engine.seeds import sr_seed
    from repro_torch.graph.analysis import live_stash_bytes
    from repro_torch.graph.models import device_graph
    from repro_torch.parallel.halo import build_halo_program, rank_round
    from repro_torch.staticcheck import saved_audit

    dg = device_graph(g, cfg.arch, "cuda")
    for policy in AUDIT_PLACEMENTS:
        stash = (StashPolicy() if policy is None
                 else StashPolicy(kind="arena", placement=policy))
        audited_forward(torch, saved_audit.gnn_setup(
            model, dg, cfg, stash, "auto", sr_seed(0)),
            f"full offload={policy}",
            sum(live_stash_bytes(cfg, g.n_feats, g.n_nodes)),
            model.flat_params())
    del dg
    prog = build_halo_program(g, 1, 1)
    tables = rank_round(prog, 0, 0, cfg.arch, "cuda")
    feats = torch.from_numpy(prog.features[0, 0]).to("cuda")
    audited_forward(torch, saved_audit.mesh_setup(
        model, feats, tables, cfg, sr_seed(0)),
        f"mesh one rank, {prog.n_pad} rows",
        sum(live_stash_bytes(cfg, g.n_feats, prog.n_pad)),
        model.flat_params())
    torch.cuda.empty_cache()


def example(name: str):
    """``examples/torch_<name>.py`` as a module (its ``main(argv)``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example_shapes(torch, qk, ref) -> dict:
    """The quant kernels at EXAMPLE_QUANT's shapes: codes bit-equal to the
    plain version, dequantized within its band, timed beside it and the
    bound."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = {}
    for n_blocks, G in EXAMPLE_QUANT:
        tag, q, d = quant_case(torch, qk, ref, n_blocks, G, 2, None, flush,
                               gen, plain_iters=5)
        rows[("quant_pack", f"example {tag}")] = q
        rows[("dequant_unpack", f"example {tag}")] = d
    del flush
    torch.cuda.empty_cache()
    return rows


def slice_examples(torch, wrappers, g) -> collections.Counter:
    """Phase 15 (c): the four examples through their ``main`` on the card,
    each counted: finite losses, the GNN rows' M column equal to
    ``activation_memory_report`` (and to the live stash of every
    compressed row and of the mini-batch peak)."""
    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.graph.analysis import live_stash_bytes
    from repro_torch.graph.train import activation_memory_report

    total = collections.Counter()
    # quickstart: 3 RP-8 configs, 21 compressions and reconstructions each
    res, counts, _ = counted_run(
        torch, wrappers, planned(3 * 21, 3 * 21, 1), "example quickstart",
        lambda: example("quickstart").main(["--device", "cuda"]))
    total.update(counts)
    if not all(math.isfinite(r["err_mean"]) and r["err_mean"]
               < r["err_one_seed"] for r in res["rows"]):
        raise AssertionError("[example quickstart] the mean over seeds is "
                             "not closer than one seed")

    # train_gnn_iexact: four RP-8 rows of 5 epochs, a mini-batch row of 4
    # batches x 5 epochs, 3 layers each
    want = planned(3, 3, 4 * 5 + 4 * 5)
    res, counts, _ = counted_run(
        torch, wrappers, want, "example train_gnn_iexact",
        lambda: example("train_gnn_iexact").main(EXAMPLE_GNN_ARGV))
    total.update(counts)
    for row in res["rows"]:
        rep = activation_memory_report(g, row["cfg"])
        m = rep.get("compressed_bytes", rep["fp32_bytes"])
        live = live_stash_bytes(row["cfg"], g.n_feats, g.n_nodes)
        ok = (row["m_bytes"] == m and row["stash_bytes"] == live
              and all(math.isfinite(x) for x in row["losses"]))
        if row["cfg"].compression is not None:
            ok &= sum(live) == m
        log(f"[example train_gnn_iexact] {row['name']}: M {row['m_bytes']} "
            f"(report {m}), stash {row['stash_bytes']}, losses "
            f"{row['losses']}, acc {row['test_acc']}")
        if not ok:
            raise AssertionError(f"[example] {row['name']}: M or losses")
    b = res["batched"]
    rep = activation_memory_report(g, b["cfg"], n_parts=4,
                                   batch_nodes=b["batch_nodes"])
    peak = rep["batched"]["peak_saved_bytes"]
    log(f"[example train_gnn_iexact] mini-batch: peak M {b['peak_bytes']} "
        f"(report {peak}), stash {b['stash_bytes']}, losses {b['losses']}")
    if not (b["peak_bytes"] == peak == sum(b["stash_bytes"])
            and all(math.isfinite(x) for x in b["losses"])):
        raise AssertionError("[example] mini-batch row: M or losses")

    # serve_decode: flash at every prefill attention, and at the enc-dec's
    # cross-attention each decode step
    for arch in EXAMPLE_SERVE_ARCHS:
        cfg = reduce_for_smoke(ARCHS[arch])
        flash = (len(cfg.shared_attn_sites()) if cfg.family == "hybrid"
                 else cfg.encoder_layers + cfg.n_layers * 31)
        want = dict(planned(0, 0, 0), flash_attention=flash)
        res, counts, _ = counted_run(
            torch, wrappers, want, f"example serve_decode {arch}",
            lambda: example("serve_decode").main(
                ["--arch", arch, "--device", "cuda"]))
        total.update(counts)
        log(f"[example serve_decode {arch}] tokens {res['tokens'][0, :8]}")
        if not res["logits_finite"] or res["tokens"].shape != (4, 32):
            raise AssertionError(f"[example serve_decode {arch}]")

    # train_lm_compressed: the act stash and the 8-bit moments run the
    # quant kernels
    for w in wrappers:
        w.launches = 0
    res = example("train_lm_compressed").main(EXAMPLE_LM_ARGV)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    log(f"[example train_lm_compressed] launches {counts}; losses "
        f"{ {m: r['losses'] for m, r in res.items()} }")
    if not (counts["quant_pack"] and counts["dequant_unpack"]
            and all(math.isfinite(x) for r in res.values()
                    for x in r["losses"])):
        raise AssertionError("[example train_lm_compressed]")
    total.update(counts)
    return total


def slice_check(torch, wrappers, qk, ref) -> tuple:
    """Phase 15 in order; returns its launch counts and kernel rows."""
    from repro_torch.graph.data import arxiv_like
    from repro_torch.graph.models import GNN, GNNConfig
    from repro_torch.core.compressor import CompressionConfig

    t0 = time.perf_counter()
    launches = slice_check_matrix(torch, wrappers)
    log(f"phase 15 (a): {time.perf_counter() - t0:.1f} s")
    g = arxiv_like(scale=1.0)
    cfg = GNNConfig(arch="sage", hidden=(256, 256), n_classes=40,
                    compression=CompressionConfig(2, 256, rp_ratio=8,
                                                  vm=True))
    model = GNN(cfg, g.n_feats,
                generator=torch.Generator().manual_seed(0)).to("cuda")
    slice_check_full(torch, g, cfg, model)
    log(f"phase 15 (b): {time.perf_counter() - t0:.1f} s")
    launches.update(slice_examples(torch, wrappers, g))
    log(f"phase 15 (c): {time.perf_counter() - t0:.1f} s")
    rows = check_example_shapes(torch, qk, ref)
    del g, model
    torch.cuda.empty_cache()
    return launches, rows


T_START = time.perf_counter()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import random_projection as rpmod
    from repro_torch.core.compressor import CompressionConfig
    from repro_torch.graph.analysis import saved_bytes_per_layer
    from repro_torch.graph.data import arxiv_like
    from repro_torch.graph.models import GNN, GNNConfig
    from repro_torch.graph.train import train_gnn
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_matmul as fk
    from repro_torch.kernels import quant_blockwise as qk
    from repro_torch.kernels import rp_matmul as rk

    # 1. device
    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    logs = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(build.SOURCES)})")
    for name, text in logs.items():
        log(f"--- nvcc {name}\n{text.strip()}")

    # 3. kernels against their plain versions
    comp = CompressionConfig(bits=2, group_size=256, rp_ratio=8, vm=True)
    cfg = GNNConfig(arch="sage", hidden=(256, 256), n_classes=40,
                    compression=comp)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    rows = check_quant(torch, qk, ref, comp.levels(), flush, gen)
    rows.update(check_rp(torch, rk, ref, rpmod, flush, gen))
    comp0 = CompressionConfig(bits=2, group_size=256, rp_ratio=0, vm=True)
    cfg0 = GNNConfig(arch="sage", hidden=(256, 256), n_classes=40,
                     compression=comp0)
    rows.update(check_fused(torch, fk, qk, ref, comp0.levels(), flush, gen))
    rows.update(check_flash(torch, fa, ref, flush, gen))
    rows.update(check_kv_quant(torch, qk, ref, flush, gen))
    small_cfg = GNNConfig(arch="sage", hidden=(64, 64), n_classes=40,
                          compression=comp)
    check_small_training(torch, train_gnn, small_cfg, arxiv_like(scale=0.004))

    # 4. slice 1 (RP 8); slice 2 (no RP, fused) follows its profile
    t0 = time.perf_counter()
    g = arxiv_like(scale=1.0)
    log(f"arxiv-like: {g.n_nodes} nodes, {g.n_edges} edges, built in "
        f"{time.perf_counter() - t0:.1f} s")
    if g.n_nodes != N_NODES:
        raise AssertionError(f"expected {N_NODES} nodes")
    check_spmm(torch, g, flush, gen)
    del flush
    model0 = GNN(cfg, g.n_feats, generator=torch.Generator().manual_seed(0))
    wrappers = (qk.quant_pack, qk.dequant_unpack, rk.rp_project,
                rk.irp_project, fk.matmul_quant, fk.dequant_matmul,
                fa.flash_attention)
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = train_gnn(g, cfg, n_epochs=EPOCHS, seed=0, params=model0)
    rep_a = train_gnn(g, cfg, n_epochs=1, seed=0, params=model0)
    rep_b = train_gnn(g, cfg, n_epochs=1, seed=0, params=model0)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()

    for epoch, loss, ms in res["history"]:
        log(f"epoch {epoch}: loss {loss!r} {ms:.3f} ms")
    log(f"val_acc {res['val_acc']} test_acc {res['test_acc']} "
        f"epochs/s {res['epochs_per_sec']}")
    log(f"max_memory_allocated {peak} bytes")
    if peak > RP8_PEAK + 2**20:
        raise AssertionError(f"peak {peak} bytes above {RP8_PEAK} + 1 MB")
    steps = EPOCHS + 2
    log(f"launches over {steps} steps: {launches}")
    for name, n in launches.items():
        # RP 8: nothing fuses, and no attention
        want = 0 if name in FUSED + ("flash_attention",) else 3 * steps
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected {want}")
    ledger = [r["compressed_bytes"]
              for r in saved_bytes_per_layer(cfg, g.n_feats, g.n_nodes)]
    log(f"live stash bytes per layer {res['stash_bytes']} ledger {ledger}")
    if res["stash_bytes"] != ledger:
        raise AssertionError("live stash bytes differ from the ledger")
    losses = [h[1] for h in res["history"]]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    same = (rep_a["history"][0][1] == rep_b["history"][0][1]
            == res["history"][0][1]
            and all(torch.equal(p, q) for p, q in
                    zip(rep_a["model"].parameters(),
                        rep_b["model"].parameters())))
    if not same:
        raise AssertionError("repeated step is not bit-identical")
    log("repeated step: loss and params bit-identical")
    profile_step(torch, g, cfg, res["model"])
    launches.update(slice_rp0(torch, g, cfg0, model0, wrappers,
                              saved_bytes_per_layer))
    del res, rep_a, rep_b
    torch.cuda.empty_cache()

    # 6. slice 4: autoprec, 8-bit VM, Table 1's flickr rows, 8-bit AdamW
    table1 = slice_table1(torch, g, cfg, model0, wrappers)
    for name in ("quant_pack", "dequant_unpack", "rp_project",
                 "irp_project"):
        launches[name] += table1[name]
    torch.cuda.empty_cache()

    # 7. slice 10: the mini-batch partition engine
    t0 = time.perf_counter()
    batched = slice_batched(torch, g, cfg, cfg0, model0, wrappers, peak)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    for name, n in batched.items():
        launches[name] += n
    torch.cuda.empty_cache()

    # 9 (a)-(d). slice 11: the stash arena and offload engine
    t0 = time.perf_counter()
    for name, n in slice_offload(torch, g, cfg, cfg0, model0,
                                 wrappers).items():
        launches[name] += n
    log(f"phase 9 (a)-(d): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 10. slice 12: the mesh engine, one rank and two sharing the card
    t0 = time.perf_counter()
    for name, n in slice_mesh(torch, g, cfg, model0, wrappers).items():
        launches[name] += n
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 11 (a)-(d). slice 13: observability
    t0 = time.perf_counter()
    for name, n in slice_obs(torch, g, cfg, model0, wrappers).items():
        launches[name] += n
    obs_s = time.perf_counter() - t0
    log(f"phase 11 (a)-(d): {obs_s:.1f} s")
    del g, model0
    torch.cuda.empty_cache()

    # 8. slice 3: serving
    served = slice_serve(torch, wrappers, fa, qk, ref)
    launches["flash_attention"] = served["flash_attention"]
    torch.cuda.empty_cache()

    # 9 (e). the KV cache's host placements
    t0 = time.perf_counter()
    check_serve9_shapes(torch, qk, fa, ref, gen)
    served9, model9, device9 = slice_offload_serve(torch, wrappers)
    log(f"phase 9 (e): {time.perf_counter() - t0:.1f} s; launches {served9}")

    # 11 (e). the serving engine's obs session
    t0 = time.perf_counter()
    served11 = slice_obs_serve(torch, wrappers, model9, device9)
    obs_s += time.perf_counter() - t0
    log(f"phase 11: {obs_s:.1f} s in all ((e) included); (e) launches "
        f"{served11}")
    if not obs_s < PHASE11_LIMIT_S:
        raise AssertionError(f"phase 11 took {obs_s:.1f} s, over "
                             f"{PHASE11_LIMIT_S} s")
    del model9, device9
    torch.cuda.empty_cache()

    # 12. slice 14: the training launcher, graph and LM halves
    t0 = time.perf_counter()
    for part in (slice_launcher_graph, slice_launcher_lm,
                 slice_launcher_resume):
        for name, n in part(torch, wrappers).items():
            launches[name] += n
        torch.cuda.empty_cache()
    launcher_s = time.perf_counter() - t0
    log(f"phase 12: {launcher_s:.1f} s")
    if not launcher_s < PHASE12_LIMIT_S:
        raise AssertionError(f"phase 12 took {launcher_s:.1f} s, over "
                             f"{PHASE12_LIMIT_S} s")

    # 13. slice 15: the MoE family
    t0 = time.perf_counter()
    moe_rows = check_moe_shapes(torch, fa, qk, ref)
    log(f"phase 13 kernels: {time.perf_counter() - t0:.1f} s")
    served13, moe_layer = slice_moe_serve(torch, wrappers, qk, ref)
    log(f"phase 13 (a)-(b): {time.perf_counter() - t0:.1f} s")
    launches13 = collections.Counter(served13)
    launches13.update(slice_moe_arctic(torch, wrappers))
    log(f"phase 13 (c): {time.perf_counter() - t0:.1f} s")
    launches13.update(slice_moe_train(torch, wrappers))
    moe_s = time.perf_counter() - t0
    log(f"phase 13: {moe_s:.1f} s; launches {dict(launches13)}")
    for name, n in launches13.items():
        launches[name] += n
    if not moe_s < PHASE13_LIMIT_S:
        raise AssertionError(f"phase 13 took {moe_s:.1f} s, over "
                             f"{PHASE13_LIMIT_S} s")

    # 14. slice 16: the SSM, hybrid and enc-dec families
    t0 = time.perf_counter()
    family_rows = check_family_shapes(torch, fa, qk, ref)
    log(f"phase 14 kernels: {time.perf_counter() - t0:.1f} s")
    launches14 = slice_family_serve(torch, wrappers)
    served14 = dict(launches14)
    log(f"phase 14 (a)-(c): {time.perf_counter() - t0:.1f} s")
    launches14.update(slice_family_train(torch, wrappers))
    family_s = time.perf_counter() - t0
    log(f"phase 14: {family_s:.1f} s; launches {dict(launches14)}")
    for name, n in launches14.items():
        launches[name] += n
    if not family_s < PHASE14_LIMIT_S:
        raise AssertionError(f"phase 14 took {family_s:.1f} s, over "
                             f"{PHASE14_LIMIT_S} s")

    # 15. the static checker and the examples
    t0 = time.perf_counter()
    launches15, example_rows = slice_check(torch, wrappers, qk, ref)
    check_s = time.perf_counter() - t0
    log(f"phase 15: {check_s:.1f} s; launches {dict(launches15)}")
    for name, n in launches15.items():
        launches[name] += n
    if not check_s < PHASE15_LIMIT_S:
        raise AssertionError(f"phase 15 took {check_s:.1f} s, over "
                             f"{PHASE15_LIMIT_S} s")

    # 16. results
    sources = {"quant_pack": ("src/repro_torch/csrc/quant_blockwise.cu",
                              "src/repro/kernels/quant_blockwise.py:62"),
               "dequant_unpack": ("src/repro_torch/csrc/quant_blockwise.cu",
                                  "src/repro/kernels/quant_blockwise.py:86"),
               "rp_project": ("src/repro_torch/csrc/rp_matmul.cu",
                              "src/repro/kernels/rp_matmul.py:24"),
               "irp_project": ("src/repro_torch/csrc/rp_matmul.cu",
                               "src/repro/kernels/rp_matmul.py:24"),
               "matmul_quant": ("src/repro_torch/csrc/fused_matmul.cu",
                                "src/repro/kernels/fused_matmul.py:80"),
               "dequant_matmul": ("src/repro_torch/csrc/fused_matmul.cu",
                                  "src/repro/kernels/fused_matmul.py:156"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:27")}
    # one row per kernel: its largest main-path shape (VM for quant)
    main_tag = {"quant_pack": "42336x256 vm", "dequant_unpack": "42336x256 vm",
                "rp_project": f"{N_NODES}x512->64",
                "irp_project": f"{N_NODES}x64->512",
                "matmul_quant": f"{N_NODES}x512@512x256",
                "dequant_matmul": f"{N_NODES}x512@512x256",
                "flash_attention": "prefill bf16"}
    rows.update(moe_rows)
    # phase 13's shapes of the kernels it runs, beside each kernel's row
    moe_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "sdpa_bf16_ms", "mismatch_share")
    moe_shapes = collections.defaultdict(dict)
    for (name, tag), row in moe_rows.items():
        moe_shapes[name][tag] = {k: row[k] for k in moe_keys if k in row}
    # and phase 14's, and phase 15's (the GNN example's G = 32 and 2048)
    rows.update(family_rows)
    family_shapes = collections.defaultdict(dict)
    for (name, tag), row in family_rows.items():
        family_shapes[name][tag] = {k: row[k] for k in moe_keys if k in row}
    rows.update(example_rows)
    example_shapes = collections.defaultdict(dict)
    for (name, tag), row in example_rows.items():
        example_shapes[name][tag] = {k: row[k] for k in moe_keys if k in row}
    kernels = []
    for name, (source, replaces) in sources.items():
        row = rows[(name, main_tag[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for (n, _), r in rows.items()
                               if n == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": main_tag[name],
            **{key: row[key] for key in ("unfused_ms", "sdpa_bf16_ms",
                                         "mismatch_share",
                                         "single_p_mismatch_share")
               if key in row},
            **({"serving_launches": served[name]}
               if name in ("quant_pack", "dequant_unpack") else {}),
            **({"moe_shapes": moe_shapes[name], "moe_serving_launches":
                served13[name]} if name in moe_shapes else {}),
            **({"family_shapes": family_shapes[name],
                "family_serving_launches": served14[name]}
               if name in family_shapes else {}),
            **({"example_shapes": example_shapes[name],
                "phase15_launches": launches15[name]}
               if name in example_shapes else {})})
    log(f"[moe] decode experts {moe_layer}")
    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
