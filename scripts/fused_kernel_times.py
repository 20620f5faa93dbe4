#!/usr/bin/env python3
"""Check and time the port's fused matmul-quantize pair alone on one GPU.

    python3 scripts/fused_kernel_times.py

Runs ``chip_smoke.check_fused`` (the three layer shapes of the rp_ratio-0
SAGE slice: the stash bit-equal to the plain version and to quant_pack, y
and dw within their bounds, then CUDA-event medians of the kernel, the
plain version, the product alone and the two-pass spelling) without the
training phases, in about 20 s.  To compare two versions of the kernels,
run it from the root of each checkout, one after the other on the same card.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.core.compressor import CompressionConfig  # noqa: E402
from repro_torch.kernels import fused_matmul, quant_blockwise, ref  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    levels = CompressionConfig(2, 256, 0, vm=True).levels()
    chip_smoke.check_fused(torch, fused_matmul, quant_blockwise, ref, levels,
                           flush, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
