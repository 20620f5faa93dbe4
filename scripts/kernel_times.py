#!/usr/bin/env python3
"""Check and time one of the port's kernels alone on one GPU.

    python3 scripts/kernel_times.py {rp,fused,flash} [--root CHECKOUT]

Builds the kernel's source (printing ptxas's registers, shared memory and
spills), then runs its check from ``chip_smoke.py`` at the main path's
shapes, without the training phases, in about 20 s:

- ``rp``: ``check_rp``, RP and IRP at 169,343 rows, 256 <-> 32 and
  512 <-> 64, within rtol/atol 2e-4 of the plain version and bit-identical
  from call to call, then CUDA-event medians of the kernel, the plain
  version and one ``torch.matmul`` on a stored R, beside the bound;
- ``fused``: ``check_fused``, the matmul-quantize pair at the three layer
  shapes of the rp_ratio-0 SAGE slice (the stash bit-equal to the plain
  version and to quant_pack, y and dw within their bounds, two calls of
  each bit-identical), timed beside the plain version, the product alone
  and the two-pass spelling, with the tensor-core bound of each kernel and
  its float32 SIMT bound (``f32_bound_ms``);
- ``flash``: ``check_flash``, flash attention at the serving prefill's
  (80, 1000, 128), causal, bf16 and float32, and at ragged shapes with
  q_offset / kv_len, in both scale orders, within their bands of the plain
  version (bf16 also bit-identical from call to call, with the share of
  outputs not bit-equal to the plain version's), then CUDA-event medians
  of the kernel, the plain version and float32 and bf16 SDPA, beside the
  bound.

``fused --parts`` also times measurement builds of the pair at the same
shapes (their outputs are not the function's), beside each whole kernel:
the forward with its product alone and with its quantizer alone
(``-DMATMUL_QUANT_PART=1`` / ``2`` in ``csrc/fused_matmul.cu``), and the
backward with its decode and staging alone and with its product alone
(``-DDEQUANT_MATMUL_PART=1`` / ``2``).

The last line is a JSON object of the rows.  ``--root`` runs the kernels,
wrappers and checks of another checkout of the repository instead (its own
``build/`` directory), so two versions are compared on one card by running
this script once for each root, in turns, within one call.
"""
import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def print_builds(build, sources, defines=()) -> None:
    """Build ``sources`` and print ptxas's report for each one compiled
    (``defines`` only for a checkout whose ``build.build`` takes them)."""
    logs = build.build(sources, defines) if defines else build.build(sources)
    for text in logs.values():
        print(text.strip(), flush=True)


#: Measurement builds of csrc/fused_matmul.cu: each kernel whole, its
#: product alone, and its quantizer (forward) or its decode and staging
#: (backward) alone.
PARTS = {"matmul_quant": (("all", ()),
                          ("product", ("-DMATMUL_QUANT_PART=1",)),
                          ("quantizer", ("-DMATMUL_QUANT_PART=2",))),
         "dequant_matmul": (("all", ()),
                            ("product", ("-DDEQUANT_MATMUL_PART=2",)),
                            ("stage", ("-DDEQUANT_MATMUL_PART=1",)))}


def time_parts(torch, chip_smoke, fk, build, levels, flush, gen) -> dict:
    """CUDA-event medians of the forward and the backward and of their
    parts alone, at the rp_ratio-0 slice's layer shapes."""
    defines = [d for parts in PARTS.values() for _, d in parts[1:]]
    with ThreadPoolExecutor(len(defines)) as pool:   # one nvcc each, at once
        logs = list(pool.map(lambda d: build.build(("fused_matmul",), d),
                             defines))
    for log in logs:
        for text in log.values():
            print(text.strip(), flush=True)
    rows, whole = {}, fk._lib
    try:
        for d, n in chip_smoke.FUSED_LAYERS:
            x = torch.randn((chip_smoke.N_NODES, d), device="cuda",
                            generator=gen) * 1.7
            w = torch.randn((d, n), device="cuda", generator=gen) / d ** 0.5
            g = torch.randn((chip_smoke.N_NODES, n), device="cuda",
                            generator=gen) / 400
            _, *stash = fk.matmul_quant(x, w, 2, 99, levels, group_size=256)
            calls = {"matmul_quant": lambda: fk.matmul_quant(
                         x, w, 2, 99, levels, group_size=256),
                     "dequant_matmul": lambda: fk.dequant_matmul(
                         *stash, g, 2, 256, d, levels)}
            tag = f"{chip_smoke.N_NODES}x{d}@{d}x{n}"
            for name, parts in PARTS.items():
                row = {}
                for part, flags in parts:
                    fk._lib = lambda flags=flags: whole(flags)
                    row[f"{part}_ms"] = chip_smoke.time_ms(torch, calls[name],
                                                           flush)
                print(f"{name} parts {tag}: {row}", flush=True)
                rows[(f"{name} parts", tag)] = row
            del x, w, g, stash
    finally:
        fk._lib = whole
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("rp", "fused", "flash"))
    ap.add_argument("--parts", action="store_true",
                    help="fused: also time the parts of the forward and "
                    "the backward alone")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose kernels and checks run")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import build, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}\nroot {root}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    if args.kernel == "rp":
        from repro_torch.core import random_projection as rpmod
        from repro_torch.kernels import rp_matmul
        print_builds(build, ("rp_matmul",))
        rows = chip_smoke.check_rp(torch, rp_matmul, ref, rpmod, flush, gen)
    elif args.kernel == "flash":
        from repro_torch.kernels import flash_attention
        print_builds(build, ("flash_attention",))
        rows = chip_smoke.check_flash(torch, flash_attention, ref, flush, gen)
    else:
        from repro_torch.core.compressor import CompressionConfig
        from repro_torch.kernels import fused_matmul, quant_blockwise
        print_builds(build, ("fused_matmul", "quant_blockwise"))
        levels = CompressionConfig(2, 256, 0, vm=True).levels()
        rows = chip_smoke.check_fused(torch, fused_matmul, quant_blockwise,
                                      ref, levels, flush, gen)
        if args.parts:
            rows.update(time_parts(torch, chip_smoke, fused_matmul, build,
                                   levels, flush, gen))
    print(json.dumps({f"{name} {tag}": row for (name, tag), row in rows.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
