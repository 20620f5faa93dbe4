#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the main path, from ``src/repro_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, timed with CUDA events (cold L2) beside the plain version,
   the one-call PyTorch yardstick where there is one, and the card's bound;
   then a small training run with the kernels against the plain path, and
   the full-size aggregation (spmm) checked for bit-reproducibility;
4. the slice: full-graph i-EXACT GraphSAGE training (arxiv-like at full
   size, hidden 256-256, INT2, G=256, RP 8, VM) through ``train_gnn`` on
   the card, with launch counts, the live stash against the byte ledger, a
   falling finite loss and a bit-identical repeated step; then one profiled
   step (device time per kernel, idle share);
5. a JSON line of per-kernel numbers, then ``{"ok": true, "device": ...}``.

It imports nothing of JAX; without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

N_NODES = 169_343                 # arxiv_like(scale=1.0)
EPOCHS = 5


def log(*args):
    print(*args, flush=True)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for the work, and which of bytes or operations set it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
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


def check_quant(torch, qk, ref, levels, flush, gen) -> dict:
    """quant_pack / dequant_unpack at the main path's block counts."""
    rows = {}
    for n_blocks in (21_168, 42_336):
        x = torch.randn((n_blocks, 256), device="cuda", generator=gen) * 2.3
        for lv in (None, levels):
            tag = f"{n_blocks}x256 {'vm' if lv else 'uniform'}"
            pk, zk, rk = qk.quant_pack(x, 2, 1234, lv)
            pr, zr, rr = ref.quantize_packed(x, 2, 1234, lv)
            torch.cuda.synchronize()
            if not (torch.equal(pk, pr) and torch.equal(zk, zr)
                    and torch.equal(rk, rr)):
                raise AssertionError(f"quant_pack {tag}: not bit-equal to "
                                     "the plain version")
            dk = qk.dequant_unpack(pk, zk, rk, 2, 256, lv)
            dr = ref.dequantize_packed(pr, zr, rr, 2, 256, lv)
            # the kernel's triplet read back through the plain decoder: any
            # differing word, zero or range shows as a value error
            q_err = max(float((zk - zr).abs().max()),
                        float((rk - rr).abs().max()),
                        float((ref.dequantize_packed(pk, zk, rk, 2, 256, lv)
                               - dr).abs().max()))
            torch.cuda.synchronize()
            # bit-equal by construction (the same roundings in the same
            # order); allowed 1e-6 in case a library kernel fuses differently
            d_err = float((dk - dr).abs().max())
            if d_err > 1e-6:
                raise AssertionError(f"dequant_unpack {tag}: max abs err "
                                     f"{d_err}")
            w = n_blocks * 256 // 16
            q_bytes = n_blocks * 256 * 4 + w * 4 + 8 * n_blocks
            # per element: ~6 float ops (normalize, clip, SR compare) and
            # ~12 integer ops (hash, pack); 4 per element to dequantize
            q_bound = bound(q_bytes, 18 * n_blocks * 256)
            d_bound = bound(q_bytes, 4 * n_blocks * 256)
            q = dict(ms=time_ms(torch, lambda: qk.quant_pack(x, 2, 1234, lv), flush),
                     plain_ms=time_ms(torch, lambda: ref.quantize_packed(x, 2, 1234, lv), flush),
                     bound_ms=q_bound[0], bound_by=q_bound[1], max_abs_err=q_err,
                     library_ms=None, bytes=q_bytes)
            d = dict(ms=time_ms(torch, lambda: qk.dequant_unpack(pk, zk, rk, 2, 256, lv), flush),
                     plain_ms=time_ms(torch, lambda: ref.dequantize_packed(pr, zr, rr, 2, 256, lv), flush),
                     bound_ms=d_bound[0], bound_by=d_bound[1], max_abs_err=d_err,
                     library_ms=None, bytes=q_bytes)
            log(f"quant_pack     {tag}: bit-equal, max abs err {q_err}; {q}")
            log(f"dequant_unpack {tag}: max abs err {d_err}; {d}")
            rows[("quant_pack", tag)] = q
            rows[("dequant_unpack", tag)] = d
    return rows


def check_rp(torch, rk, ref, rpmod, flush, gen) -> dict:
    """RP and IRP at the main path's shapes, rtol/atol 2e-4 (the kernel and
    cuBLAS sum the same float32 products in different orders)."""
    rows = {}
    for d_in, r in ((256, 32), (512, 64)):
        for name in ("rp_project", "irp_project"):
            k, n = (d_in, r) if name == "rp_project" else (r, d_in)
            x = torch.randn((N_NODES, k), device="cuda", generator=gen)
            if name == "rp_project":
                kern = lambda: rk.rp_project(x, 77, r)
                plain = lambda: ref.rp_project(x, 77, r)
                mat = rpmod.rp_matrix(77, d_in, r, "cuda")
            else:
                kern = lambda: rk.irp_project(x, 77, d_in)
                plain = lambda: ref.irp_project(x, 77, d_in)
                mat = rpmod.rp_matrix(77, d_in, r, "cuda").T.contiguous()
            yk, yr = kern(), plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(yk, yr, rtol=2e-4, atol=2e-4)
            err = float((yk - yr).abs().max())
            nbytes = N_NODES * (k + n) * 4
            b = bound(nbytes, 2 * N_NODES * k * n)
            row = dict(ms=time_ms(torch, kern, flush),
                       plain_ms=time_ms(torch, plain, flush),
                       library_ms=time_ms(torch, lambda: torch.matmul(x, mat), flush),
                       bound_ms=b[0], bound_by=b[1], max_abs_err=err,
                       bytes=nbytes, flops=2 * N_NODES * k * n)
            tag = f"{N_NODES}x{k}->{n}"
            log(f"{name:14s} {tag}: within 2e-4; {row}")
            rows[(name, tag)] = row
    return rows


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


def profile_step(torch, g, cfg, model) -> None:
    """Where one training step's time goes: device time per kernel name
    (torch.profiler, CUPTI) and the device's idle share of the step's wall
    time.  Runs after the main path's launch counts were read."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.compile import CompiledFull
    from repro_torch.graph.models import device_graph
    from repro_torch.optim import AdamWConfig

    step = CompiledFull(device_graph(g, cfg.arch, "cuda"), cfg, model,
                        AdamWConfig(lr=5e-3))
    step.step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.step(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profiled step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}")
    for ms, count, key in rows[:15]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {key[:100]}")


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
    from repro_torch.kernels import quant_blockwise as qk
    from repro_torch.kernels import rp_matmul as rk

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
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
    small_cfg = GNNConfig(arch="sage", hidden=(64, 64), n_classes=40,
                          compression=comp)
    check_small_training(torch, train_gnn, small_cfg, arxiv_like(scale=0.004))

    # 4. the slice
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
                rk.irp_project)
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
    steps = EPOCHS + 2
    log(f"launches over {steps} steps: {launches}")
    for name, n in launches.items():
        if n != 3 * steps:
            raise AssertionError(f"{name}: {n} launches, expected "
                                 f"{3 * steps} (3 per step)")
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

    # 5. results
    sources = {"quant_pack": ("src/repro_torch/csrc/quant_blockwise.cu",
                              "src/repro/kernels/quant_blockwise.py:62"),
               "dequant_unpack": ("src/repro_torch/csrc/quant_blockwise.cu",
                                  "src/repro/kernels/quant_blockwise.py:86"),
               "rp_project": ("src/repro_torch/csrc/rp_matmul.cu",
                              "src/repro/kernels/rp_matmul.py:24"),
               "irp_project": ("src/repro_torch/csrc/rp_matmul.cu",
                               "src/repro/kernels/rp_matmul.py:24")}
    # one row per kernel: its largest main-path shape (VM for quant)
    main_tag = {"quant_pack": "42336x256 vm", "dequant_unpack": "42336x256 vm",
                "rp_project": f"{N_NODES}x512->64",
                "irp_project": f"{N_NODES}x64->512"}
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
            "library_ms": row["library_ms"], "shape": main_tag[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
