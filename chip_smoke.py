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
   and the window dequant_unpack at the KV cache's shapes; RP/IRP also bit-identical from call to call, with the
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
8. slice 3: serving full-width qwen1.5-4b (random bf16 weights, seed 0)
   through ``repro_torch.launch.serve``'s engine: 8 requests of 1000 prompt
   tokens and 32 generated, 4 slots, continuous batching, 4-bit KV pages
   (G=64, 16 tokens a page).  Every request served with 32 tokens; launch
   counts as planned (flash 80, seeded quant_pack 5120, dequant_unpack
   4960, no plain attention on the card); the live pool's bytes equal the
   layout's; TTFT, TPOT, tokens/s and peak memory of that run, which
   collects no logits, as the launcher runs; two more runs that collect
   the logits give the same tokens and identical, finite logits; at 2
   layers of full width the prefill logits with the kernel agree with the
   plain attention on the card; prefill and decode step times, and one
   profiled prefill and decode step;
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
   backward), profiled under the host placements (the side stream's copy
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
11. a JSON line of per-kernel numbers, then ``{"ok": true, "device": ...}``.

It imports nothing of JAX; without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
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
               ("adamw8", 1, 256, 8, None))


#: Phase 7's 2-bit VM blocks of 256: the RP-8 stashes of a halo-0 batch
#: (21,184 rows at 32 and 64 columns after RP) and of a halo-1 batch
#: (132,032 rows), and the rp_ratio-0 "off" stashes of a halo-0 batch
#: (21,184 x 256 and x 512).
BATCH_QUANT_BLOCKS = (2_648, 5_296, 16_504, 33_008, 21_184, 42_368)


def quant_case(torch, qk, ref, n_blocks, G, bits, lv, flush, gen) -> tuple:
    """quant_pack / dequant_unpack at one shape: bit-equal to the plain
    version, then timed beside it and the bound.  Returns the two rows."""
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
             plain_ms=time_ms(torch, lambda: ref.quantize_packed(x, bits, 1234, lv), flush),
             bound_ms=q_bound[0], bound_by=q_bound[1], max_abs_err=q_err,
             library_ms=None, bytes=q_bytes)
    d = dict(ms=time_ms(torch, lambda: qk.dequant_unpack(pk, zk, rk, bits, G, lv), flush),
             plain_ms=time_ms(torch, lambda: ref.dequantize_packed(pr, zr, rr, bits, G, lv), flush),
             bound_ms=d_bound[0], bound_by=d_bound[1], max_abs_err=d_err,
             library_ms=None, bytes=q_bytes)
    log(f"quant_pack     {tag}: bit-equal, max abs err {q_err}; {q}")
    log(f"dequant_unpack {tag}: max abs err {d_err}; {d}")
    return tag, q, d


def check_quant(torch, qk, ref, levels, flush, gen) -> dict:
    """quant_pack / dequant_unpack at the main path's block counts: slice
    1's 2-bit blocks of 256 (uniform and VM), phase 7's
    (BATCH_QUANT_BLOCKS), then EXTRA_QUANT (ragged words and the 256-level
    table)."""
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
            stats: int = 0, moments: int = 0) -> dict:
    """Launches of a run of the unfused (RP or declined) spelling: each
    training step and each autoprec probe quantizes, dequantizes, projects
    and recovers every compressed layer once (RP and IRP only for RP
    layers); an autoprec stats pass projects every RP layer once; 8-bit
    AdamW quantizes its ``moments`` moment leaves once at init and after
    every step, and dequantizes them every step."""
    passes = steps + probes
    return {"quant_pack": n_comp * passes + moments * (steps + 1),
            "dequant_unpack": n_comp * passes + moments * steps,
            "rp_project": n_rp * (passes + stats),
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


def check_flash(torch, fa, ref, flush, gen) -> dict:
    """flash_attention against its plain version: at the serving prefill
    shape, causal, bf16 (atol 1e-3, rtol 2**-7: an output may round to the
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
    kernel keeps."""
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
    bh, s, dh = FLASH_SHAPE
    # (atol, rtol): float32 within 3e-5; a bf16 output within one bf16 ulp
    # of the plain version's (2**-7 relative), 1e-3 absolute near zero
    f32_tol, bf16_tol = (3e-5, 3e-5), (1e-3, 2.0 ** -7)
    cases = [("prefill bf16", FLASH_SHAPE, s, torch.bfloat16, True, 0, None,
              bf16_tol),
             ("prefill f32", FLASH_SHAPE, s, torch.float32, True, 0, None,
              f32_tol),
             ("ragged f32", (6, 70, 128), 200, torch.float32, True, 130,
              None, f32_tol),
             ("ragged kv_len bf16", (6, 77, 128), 200, torch.bfloat16, True,
              60, 137, bf16_tol),
             ("full kv_len f32", (6, 70, 64), 200, torch.float32, False, 0,
              131, f32_tol)]
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
            if tag == "prefill bf16":
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
        if tag.startswith("prefill"):
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
KV_WINDOW_TOKENS = 4 * 65 * 16       # the decode window of 4 slots


def check_kv_quant(torch, qk, ref, flush, gen) -> dict:
    """The KV cache's use of the quant kernels: quant_pack with one seed per
    token (counters restarting per token) at a prefill group's and a
    decode step's rows, bit-equal to the plain version; dequant_unpack of
    a decode window's pages, bit-equal to the plain version.  Timed."""
    from repro_torch.engine.seeds import kv_seed

    rows = {}
    for tag, n_tok in (("kv prefill", KV_PREFILL_TOKENS), ("kv decode", 4)):
        x = torch.randn((n_tok * KV_NBT, KV_G), device="cuda",
                        generator=gen) * 1.3
        seeds = kv_seed(torch.arange(n_tok, device="cuda") % 1008,
                        torch.arange(n_tok, device="cuda") // 1008, 7, 1)
        got = qk.quant_pack(x, KV_BITS, seeds, rows_per_seed=KV_NBT)
        want = ref.quantize_packed(x, KV_BITS, seeds, rows_per_seed=KV_NBT)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"seeded quant_pack {tag}: not bit-equal")
        n = n_tok * KV_NBT
        nbytes = n * KV_G * 4 + n * KV_G * KV_BITS // 8 + 8 * n + 4 * n_tok
        bnd = bound(nbytes, 18 * n * KV_G)
        row = dict(ms=time_ms(torch, lambda: qk.quant_pack(
                       x, KV_BITS, seeds, rows_per_seed=KV_NBT), flush),
                   plain_ms=time_ms(torch, lambda: ref.quantize_packed(
                       x, KV_BITS, seeds, rows_per_seed=KV_NBT), flush),
                   bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=0.0,
                   library_ms=None, bytes=nbytes)
        log(f"quant_pack (seeded) {tag} {n}x{KV_G}: bit-equal; {row}")
        rows[("quant_pack", f"{tag} {n}x{KV_G}")] = row
    n = KV_WINDOW_TOKENS * KV_NBT
    x = torch.randn((n, KV_G), device="cuda", generator=gen)
    pk, zk, rk = qk.quant_pack(x, KV_BITS, 5)
    got = qk.dequant_unpack(pk, zk, rk, KV_BITS, KV_G)
    want = ref.dequantize_packed(pk, zk, rk, KV_BITS, KV_G)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > 1e-6:
        raise AssertionError(f"dequant_unpack kv window: max abs err {err}")
    nbytes = n * KV_G * 4 + n * KV_G * KV_BITS // 8 + 8 * n
    bnd = bound(nbytes, 4 * n * KV_G)
    row = dict(ms=time_ms(torch, lambda: qk.dequant_unpack(
                   pk, zk, rk, KV_BITS, KV_G), flush),
               plain_ms=time_ms(torch, lambda: ref.dequantize_packed(
                   pk, zk, rk, KV_BITS, KV_G), flush),
               bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err,
               library_ms=None, bytes=nbytes)
    log(f"dequant_unpack kv window {n}x{KV_G}: max abs err {err}; {row}")
    rows[("dequant_unpack", f"kv window {n}x{KV_G}")] = row
    return rows


SERVE_ARGV = ["--arch", "qwen1.5-4b", "--requests", "8", "--max-batch", "4",
              "--prompt-len", "1000", "--gen-len", "32", "--kv-bits", "4",
              "--kv-group", "64", "--page-tokens", "16", "--mode",
              "continuous", "--kv-policy", "device", "--device", "cuda"]
#: Launches over one serving run: 2 prefill groups x 40 layers of flash;
#: quant_pack once per layer and stream for each group's prompt and each of
#: the 62 decode steps (2 groups x 31); dequant_unpack once per layer and
#: stream for each decode step's window.
SERVE_LAUNCHES = {"flash_attention": 80, "quant_pack": 2 * 80 + 62 * 80,
                  "dequant_unpack": 62 * 80}
#: 40 layers x 260 pages x 51,200 bytes (4-bit words + zero/range, K and V)
SERVE_POOL_BYTES = 532_480_000


def profile_serve(torch, engine, requests) -> dict:
    """One admission group's prefill and single decode steps of a fresh
    engine: host time (synchronized), then one profiled prefill and one
    profiled decode step (device time by kernel, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    def admit():
        for r in requests[:engine.max_batch]:
            engine.sched.submit(r)
        group = engine.sched.admit()
        table = np.full((engine.max_batch, engine.max_pages_per_slot),
                        engine.layout.null_page, np.int32)
        return group, table

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def profiled(fn, what):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out, wall_ms = timed(fn)
        rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count,
                 e.key) for e in prof.key_averages()
                if getattr(e, "device_type", None)
                == torch.autograd.DeviceType.CUDA]
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        log(f"profiled {what}: wall {wall_ms:.3f} ms, device busy "
            f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}")
        log_profile(rows, 12)
        return out

    out = {}
    state = engine._init_state()
    group, table = admit()
    state, out["prefill_ms"] = timed(
        lambda: engine._admit_group(group, state, table))
    page_table = torch.as_tensor(table, device=engine.device)
    steps = []
    for _ in range(5):
        state, ms = timed(lambda: engine._step(page_table, state))
        engine.sched.tick()
        steps.append(ms)
    out["decode_ms"] = steps
    profiled(lambda: engine._step(page_table, state), "decode step")
    for si in range(engine.max_batch):
        engine.sched.complete(si)
    state = engine._init_state()
    group, table = admit()
    profiled(lambda: engine._admit_group(group, state, table),
             "prefill (4 x 1000 tokens)")
    log(f"[serve] unprofiled: prefill of a 4 x 1000 group "
        f"{out['prefill_ms']:.3f} ms; decode steps {steps} ms")
    return out


def slice_serve(torch, wrappers, fa, ref) -> dict:
    """Slice 3: serving full-width qwen1.5-4b through the launcher's engine
    (see the module docstring).  Returns the serving run's launch counts."""
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import pool_nbytes

    args = serve.parser().parse_args(SERVE_ARGV)
    t0 = time.perf_counter()
    model = serve.build_model(args)
    torch.cuda.synchronize()
    log(f"[serve] qwen1.5-4b: {model.cfg.param_count()} parameters "
        f"(ArchConfig.param_count), {sum(p.numel() for p in model.parameters())} "
        f"in the model, built in {time.perf_counter() - t0:.1f} s")

    # plain attention must not run on the card during the serving run
    plain_calls = [0]
    plain = ref.flash_attention

    def counted(q, *a, **kw):
        plain_calls[0] += q.is_cuda
        return plain(q, *a, **kw)

    # the counted and timed run is the launcher's: no logits collected
    engine, requests = serve.build_engine(args, model)
    pool_bytes = pool_nbytes(engine.pool)
    ref.flash_attention = counted
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = engine.run(requests)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    ref.flash_attention = plain
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

    profile_serve(torch, serve.build_engine(args, model)[0], requests)
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
    del two
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
                  profile_it: bool = False) -> None:
    """One forward and backward of ``cfg`` on ``graph`` through a fresh
    ArenaStore at ``policy`` (None: the per-tensor stash): host_store_bytes
    must be the plan's bytes after the forward (0 for None and "device")
    and 0 after the backward; logs the peak the step adds to what was
    allocated before it.  With ``profile_it``, a second step runs under
    torch.profiler and each stream's host copies are read against the other
    streams' kernels."""
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
        torch.cuda.synchronize()
        after = host_store_bytes()
        loss = masked_nll(logits, graph.labels, graph.train_mask)
        torch.autograd.grad(loss, model.flat_params())
        torch.cuda.synchronize()
        return after, host_store_bytes()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fwd, bwd = step(0)
    first_ms = (time.perf_counter() - t0) * 1e3
    want = 0 if policy in (None, "device") else plan.total_bytes
    log(f"[{what}] probe step: host_store_bytes {fwd} after the forward "
        f"(planned {plan.total_bytes}), {bwd} after the backward; peak "
        f"{torch.cuda.max_memory_allocated() - base} bytes above the {base} "
        f"allocated before it; {first_ms:.3f} ms (a first step: host "
        "arenas allocated)")
    if (fwd, bwd) != (want, 0):
        raise AssertionError(f"[{what}] host store {fwd} / {bwd}, expected "
                             f"{want} / 0")
    if not profile_it:
        return
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
    for policy in PLACEMENTS:
        offload_probe(torch, dg, cfg, model, policy, "auto",
                      f"offload rp8 {policy}", policy in ("host",
                                                          "pinned-paged"))

    # (b) rp_ratio 0, fused="auto": the fused backward reads the packed
    # words the reader hands back
    steps = 2
    fused_want = dict(planned(0, 0, steps), matmul_quant=3 * steps,
                      dequant_matmul=3 * steps)
    total.update(offload_runs(
        torch, wrappers, "offload rp0 auto", fused_want, PLACEMENTS,
        lambda p: train_gnn(g, cfg0, n_epochs=steps, seed=0, params=model0,
                            fused="auto", offload=p)))
    for policy in PLACEMENTS:
        offload_probe(torch, dg, cfg0, model, policy, "auto",
                      f"offload rp0 {policy}", policy == "pinned-paged")

    # (c) uncompressed: every layer's raw f32 input in the arena; the
    # host window (layers 1-2) is visibly smaller than the pool
    raw = GNNConfig(arch="sage", hidden=(256, 256), n_classes=40,
                    compression=None)
    total.update(offload_runs(
        torch, wrappers, "offload raw", planned(0, 0, 2),
        (None, "device", "pinned-paged"),
        lambda p: train_gnn(g, raw, n_epochs=2, seed=0, params=model0,
                            offload=p)))
    for policy in (None, "device", "pinned-paged"):
        offload_probe(torch, dg, raw, model, policy, "auto",
                      f"offload raw {policy}", policy == "pinned-paged")
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


#: Phase 9 (e): phase 8's recipe on 2 requests of 1000 + 8 tokens, 2 slots.
SERVE9_ARGV = ["--arch", "qwen1.5-4b", "--requests", "2", "--max-batch", "2",
               "--prompt-len", "1000", "--gen-len", "8", "--kv-bits", "4",
               "--kv-group", "64", "--page-tokens", "16", "--mode",
               "continuous", "--device", "cuda"]
#: One prefill group (40 layers of flash; quant_pack per layer and stream)
#: and 7 decode steps (quant_pack and dequant_unpack per layer and stream).
SERVE9_LAUNCHES = {"flash_attention": 40, "quant_pack": 80 + 7 * 80,
                   "dequant_unpack": 7 * 80}
#: 40 layers x 126 pages (2 x 63) x 51,200 bytes.
SERVE9_POOL_BYTES = 258_048_000


def check_serve9_shapes(torch, qk, fa, ref, gen) -> None:
    """The kernels at phase 9 (e)'s shapes against their plain versions:
    flash at (40, 1000, 128) bf16 (as check_flash's tolerance), the seeded
    quant_pack at the 2-request prefill and decode rows and dequant_unpack
    at the 2-slot window, bit-equal."""
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
    x = torch.randn((2 * 63 * 16 * KV_NBT, KV_G), device="cuda",
                    generator=gen)
    pk, zk, rk = qk.quant_pack(x, KV_BITS, 9)
    if not torch.equal(qk.dequant_unpack(pk, zk, rk, KV_BITS, KV_G),
                       ref.dequantize_packed(pk, zk, rk, KV_BITS, KV_G)):
        raise AssertionError("[serve9] dequant_unpack at the window")
    log("[serve9] flash, seeded quant_pack and dequant_unpack at phase 9 "
        "(e)'s shapes: within bands / bit-equal")


def slice_offload_serve(torch, wrappers) -> dict:
    """Phase 9 (e): the KV cache under device, host and pinned-paged:
    launches as planned, the same tokens and logits bit for bit, the pool
    on the host (pinned for pinned-paged) with the layout's bytes, TTFT,
    TPOT and peak memory of each."""
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
    del model, outs
    return dict(total)


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
    del g, model0
    torch.cuda.empty_cache()

    # 8. slice 3: serving
    served = slice_serve(torch, wrappers, fa, ref)
    launches["flash_attention"] = served["flash_attention"]
    torch.cuda.empty_cache()

    # 9 (e). the KV cache's host placements
    t0 = time.perf_counter()
    check_serve9_shapes(torch, qk, fa, ref, gen)
    served9 = slice_offload_serve(torch, wrappers)
    log(f"phase 9 (e): {time.perf_counter() - t0:.1f} s; launches {served9}")

    # 10. results
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
               if name in ("quant_pack", "dequant_unpack") else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
