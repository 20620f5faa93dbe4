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
  version and to quant_pack, y and dw within their bounds), timed beside
  the plain version, the product alone and the two-pass spelling;
- ``flash``: ``check_flash``, flash attention at the serving prefill's
  (80, 1000, 128), causal, bf16 and float32, and at ragged shapes with
  q_offset / kv_len, in both scale orders, within their bands of the plain
  version (bf16 also bit-identical from call to call, with the share of
  outputs not bit-equal to the plain version's), then CUDA-event medians
  of the kernel, the plain version and float32 and bf16 SDPA, beside the
  bound.

The last line is a JSON object of the rows.  ``--root`` runs the kernels,
wrappers and checks of another checkout of the repository instead (its own
``build/`` directory), so two versions are compared on one card by running
this script once for each root, in turns, within one call.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path


def print_builds(build, sources) -> None:
    """Build ``sources`` and print ptxas's report for each one compiled."""
    for text in build.build(sources).values():
        print(text.strip(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("rp", "fused", "flash"))
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
    print(json.dumps({f"{name} {tag}": row for (name, tag), row in rows.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
