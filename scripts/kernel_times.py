#!/usr/bin/env python3
"""Check and time one of the port's kernels alone on one GPU.

    python3 scripts/kernel_times.py {rp,fused,flash,quant} [--root CHECKOUT]

Builds the kernel's source (printing ptxas's registers, shared memory and
spills), then runs its check from ``chip_smoke.py`` at the main path's
shapes, without the training phases, in about 20 s:

- ``rp``: ``check_rp``, RP and IRP at 169,343 rows and at the mini-batch
  phase's 21,184 and 132,032 (``chip_smoke.RP_ROWS``), 256 <-> 32 and
  512 <-> 64, within rtol/atol 2e-4 of the plain version and bit-identical
  from call to call, then CUDA-event medians of the kernel, the plain
  version and one ``torch.matmul`` on a stored R, beside the bound;
- ``fused``: ``check_fused``, the matmul-quantize pair at the three layer
  shapes of the rp_ratio-0 SAGE slice, at 169,343 and 21,184 rows (the stash bit-equal to the plain
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
  bound;
- ``quant``: ``check_quant`` and ``check_kv_quant``, quantize+pack and
  unpack+dequantize at the RP-8 slice's 21,168 and 42,336 blocks of 256
  (2 bits, uniform and VM), at the mini-batch phase's blocks of 256
  (``chip_smoke.BATCH_QUANT_BLOCKS``, 2-bit VM), at Table 1's flickr shapes (89,250 and 45,696
  blocks of 125, 11,157 and 5,712 of 1000, 2 bits: ragged words), at 8-bit
  VM (42,336 and 21,168 blocks of 256, a 256-level table) and at the KV
  cache's prefill (161,280 blocks
  of 64, 4 bits, one seed per 40 blocks), decode (160 blocks) and window
  (166,400 blocks), then the same at the rp_ratio-0 slice's ``fused="off"``
  layer inputs (169,343 and 338,686 blocks of 256, 2 bits, uniform and
  VM; this mode only): every output bit-equal to the plain version, timed
  beside it and the bytes bound; the seeded kernel is also timed alone,
  without the wrapper's conversion of the seed table.

``quant --sass`` also disassembles the quant kernels' library
(``cuobjdump -sass``) and prints, for each kernel, the instructions of its
persistent loop by opcode, without the slow-path code of ``__fdiv_rn``,
and, for the vector path, per element (a lane takes 16 elements an
iteration).

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
import collections
import json
import os
import re
import shutil
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


def check_rp0_quant(torch, chip_smoke, qk, ref, levels, flush, gen) -> dict:
    """quant_pack / dequant_unpack at the rp_ratio-0 slice's unfused layer
    inputs (169,343 x 256 and x 512 as blocks of 256), bit-equal to the
    plain version, timed beside it and the bytes bound."""
    rows = {}
    for n_blocks in (chip_smoke.N_NODES, 2 * chip_smoke.N_NODES):
        x = torch.randn((n_blocks, 256), device="cuda", generator=gen) * 1.7
        for lv in (None, levels):
            tag = f"{n_blocks}x256 {'vm' if lv else 'uniform'}"
            got = qk.quant_pack(x, 2, 77, lv)
            want = ref.quantize_packed(x, 2, 77, lv)
            back = qk.dequant_unpack(*got, 2, 256, lv)
            torch.cuda.synchronize()
            if not (all(torch.equal(a, b) for a, b in zip(got, want))
                    and torch.equal(back, ref.dequantize_packed(
                        *want, 2, 256, lv))):
                raise AssertionError(f"quant {tag}: not bit-equal to the "
                                     "plain version")
            nbytes = n_blocks * 256 * 4 + n_blocks * 16 * 4 + 8 * n_blocks
            bnd = chip_smoke.bound(nbytes, 0)
            for name, fn, plain in (
                    ("quant_pack", lambda: qk.quant_pack(x, 2, 77, lv),
                     lambda: ref.quantize_packed(x, 2, 77, lv)),
                    ("dequant_unpack",
                     lambda: qk.dequant_unpack(*got, 2, 256, lv),
                     lambda: ref.dequantize_packed(*got, 2, 256, lv))):
                row = dict(ms=chip_smoke.time_ms(torch, fn, flush),
                           plain_ms=chip_smoke.time_ms(torch, plain, flush),
                           bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=0.0,
                           bytes=nbytes)
                print(f"{name} rp0 off {tag}: bit-equal; {row}", flush=True)
                rows[(name, f"rp0 off {tag}")] = row
            del got, want, back
        del x
    return rows


def time_kv_kernel(torch, chip_smoke, qk, flush, gen) -> dict:
    """The seeded quant_pack kernel alone at the KV prefill's and a decode
    step's rows: the library called with the seed table already converted
    (the wrapper converts it with three small PyTorch kernels, which
    ``check_kv_quant``'s times include)."""
    import ctypes

    from repro_torch.core.prng import MASK32
    from repro_torch.engine.seeds import kv_seed

    lib, g, bits, nbt = qk._lib(), chip_smoke.KV_G, chip_smoke.KV_BITS, \
        chip_smoke.KV_NBT
    levels = (ctypes.c_float * 16)()
    rows = {}
    for tag, n_tok in (("kv prefill", chip_smoke.KV_PREFILL_TOKENS),
                       ("kv decode", 4)):
        n = n_tok * nbt
        x = torch.randn((n, g), device="cuda", generator=gen)
        tok = torch.arange(n_tok, device="cuda")
        seeds = (kv_seed(tok % 1008, tok // 1008, 7, 1).to(torch.int64)
                 & MASK32).to(torch.int32)
        out = (torch.empty((n, g * bits // 32), dtype=torch.int32,
                           device="cuda"),
               torch.empty(n, device="cuda"), torch.empty(n, device="cuda"))

        def call():
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            err = lib.quant_pack(x.data_ptr(), *(t.data_ptr() for t in out),
                                 n, g, bits, 0, seeds.data_ptr(), nbt, 0,
                                 1, 1, levels, 0, stream)
            if err:
                raise RuntimeError(f"quant_pack: CUDA error {err}")

        call()
        want = qk.quant_pack(x, bits, seeds, rows_per_seed=nbt)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise AssertionError(f"seeded quant_pack {tag}: the library "
                                 "call differs from the wrapper's")
        row = {"kernel_ms": chip_smoke.time_ms(torch, call, flush)}
        print(f"quant_pack (seeded) {tag} {n}x{g} kernel alone: {row}",
              flush=True)
        rows[("quant_pack kernel alone", f"{tag} {n}x{g}")] = row
    return rows


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_SASS_TARGET = re.compile(r"\bBRA\b(?:\.\S+)?\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)")


def sass_report(build) -> dict:
    """Instructions of each quant kernel's persistent loop (the widest
    backward branch) by opcode, from ``cuobjdump -sass``, without its cold
    regions (a forward branch over at most 64 instructions that call
    ``__fdiv_rn``'s slow path and store nothing: taken only for tiny,
    denormal or NaN quotients); for the vector path also per element (16 a lane an
    iteration)."""
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda, "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(build.lib_path(
        "quant_blockwise"))], capture_output=True, text=True,
        check=True).stdout
    report = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        insns = [(int(a, 16), " ".join(body.split()))
                 for a, body in _SASS_INSN.findall(chunk)]
        branches = [(a, int(m.group(1), 16)) for a, body in insns
                    if "BRA.DIV" not in body
                    and (m := _SASS_TARGET.search(body))]
        loop = max(((t, a) for a, t in branches if t < a),
                   key=lambda r: r[1] - r[0], default=(0, -1))
        cold = [(a, t) for a, t in branches
                if loop[0] <= a < t <= min(loop[1] + 16, a + 64 * 16)
                and any("CALL" in body for b, body in insns if a < b < t)
                and not any("STG" in body or "SHFL" in body
                            for b, body in insns if a < b < t)]
        body = collections.Counter(
            text_.split()[1 if text_.startswith("@") else 0].split(".")[0]
            for a, text_ in insns
            if loop[0] <= a <= loop[1] and not any(s < a < t for s, t in cold))
        body.pop("NOP", None)
        n = sum(body.values())
        row = {"loop_instructions": n, "by_opcode": dict(body.most_common())}
        if "_vec_" in name:
            row["per_element"] = n / 16
        print(f"sass {name}: {row}", flush=True)
        report[name] = row
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("rp", "fused", "flash", "quant"))
    ap.add_argument("--parts", action="store_true",
                    help="fused: also time the parts of the forward and "
                    "the backward alone")
    ap.add_argument("--sass", action="store_true",
                    help="quant: also count the kernels' SASS instructions")
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
    elif args.kernel == "quant":
        from repro_torch.core.compressor import CompressionConfig
        from repro_torch.kernels import quant_blockwise
        print_builds(build, ("quant_blockwise",))
        if args.sass:
            sass_report(build)
        levels = CompressionConfig(2, 256, 8, vm=True).levels()
        rows = chip_smoke.check_quant(torch, quant_blockwise, ref, levels,
                                      flush, gen)
        rows.update(chip_smoke.check_kv_quant(torch, quant_blockwise, ref,
                                              flush, gen))
        rows.update(time_kv_kernel(torch, chip_smoke, quant_blockwise,
                                   flush, gen))
        rows.update(check_rp0_quant(torch, chip_smoke, quant_blockwise, ref,
                                    levels, flush, gen))
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
