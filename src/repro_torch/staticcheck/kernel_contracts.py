"""Declarative pre/post-conditions for the compression kernels, stated
over the CUDA launch configurations the port computes (the reference's
``repro.staticcheck.kernel_contracts``, whose TPU VMEM budget and
``(tm, tn)`` autotune cache have no counterpart here).

A :class:`Launch` is one kernel call the main path makes: its kind
(``quant``, ``rp``, ``fused``), its shape and its quantization config.
:func:`fwd_launch` and :func:`bwd_launch` re-derive what
``csrc/fused_matmul.cu`` launches for it, by the same arithmetic, and each
:class:`Contract` states one invariant over them:

* ``fused_matmul`` forward (``matmul_quant``: a CTA takes ``KBM`` rows and
  every column of y up to 256, x in chunks of at most 256 columns): a row
  tile owns whole quantization blocks (the layout is whole blocks aligned
  to rows, and in chunk mode a chunk is whole blocks, at most ``KQB /
  KBM`` of them a row); its dynamic shared memory is at most
  :data:`~repro_torch.kernels.fused_matmul.MAX_SMEM`;
* ``fused_matmul`` backward (``dequant_matmul``, its tile from
  :func:`~repro_torch.kernels.fused_matmul.tile`, its row ranges from
  :func:`~repro_torch.kernels.fused_matmul.splits`): at most
  ``MAX_SPLITS`` ranges, each whole stages of the tile, covering every row
  and none empty; scratch of ``S * d * n * 4`` bytes; shared memory from
  the same ``buffer_elems`` sum the launch uses, within the card's 227 KiB;
* ``quant_blockwise``: :func:`repro_torch.kernels.quant_blockwise.unsupported`,
  the predicate the dispatch layer routes on;
* ``rp_matmul``: the projection ratio divides the stash width.

:func:`run` checks every (layer config x width x rows) the plan matrix
launches; :func:`check_launches` takes any other list (``chip_smoke.py``
checks the shapes it launches on the card, and the tests hold them
clean).  There is no tile cache to read: the port picks its tiles by
fixed rules, and a cache arrives only with tile selection (ROADMAP A.12b,
slice 18).  A gpu test holds :func:`fwd_launch` and :func:`bwd_launch`'s
shared memory equal to the kernel library's own ``matmul_quant_smem`` /
``dequant_matmul_smem``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.kernels import fused_matmul, quant_blockwise
from repro_torch.staticcheck.findings import Finding

PASS = "kernel-contracts"

#: The card's shared memory a CTA may opt into (H100: 227 KiB).
SMEM_CAP = 232_448

# csrc/fused_matmul.cu, namespace fwd: rows of x a CTA, columns of x a
# chunk at most, blocks a quantize batch at most
KBM, KCHUNK_MAX, KQB = 64, 256, 256
#: The forward's CTA configurations by the width n of y (``kFwd``):
#: (n at most, NT, WN, KW, S); BN = 8 * NT * WN columns a CTA.
FWD_CONFIGS = ((40, 5, 1, 16, 2), (64, 8, 1, 16, 4), (None, 8, 4, 16, 2))

# namespace bwd: bf16 stage buffers, columns a producer thread decodes
KNB, KRUN = 2, 8
#: Each backward tile's ring (``kRing``): (slots R, words a block at most
#: MAXW on the ring path), in the order of ``fused_matmul.tile``'s tiles.
BWD_RINGS = {40: (4, 64), 64: (3, 64), 256: (4, 16)}


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel call: ``quant`` over (m blocks, G), ``rp`` of an (m, d)
    stash to n = d / ratio columns, ``fused`` of x (m, d) @ w (d, n)."""

    kind: str
    m: int
    d: int
    n: int
    bits: int = 2
    group_size: int = 256
    levels: tuple | None = None
    rp_ratio: int = 0

    @property
    def key(self) -> str:
        vm = f"/vm{len(self.levels)}" if self.levels else ""
        return (f"{self.kind}/{self.m}x{self.d}x{self.n}/b{self.bits}"
                f"/g{self.group_size}{vm}")


@dataclasses.dataclass(frozen=True)
class FwdLaunch:
    chunk_mode: bool
    cw: int               # columns of x a chunk
    bn: int               # columns of y a CTA
    batch: int            # blocks a quantize batch
    smem: int             # dynamic shared memory, bytes


@dataclasses.dataclass(frozen=True)
class BwdLaunch:
    tile: tuple[int, int, int]   # (rows of dw, columns, stash rows a stage)
    splits: int
    rows: int             # stash rows a range
    ring: bool
    smem: int             # dynamic shared memory of this launch, bytes
    max_smem: int         # the most the kernel is set up for, bytes
    scratch: int          # bytes of the partials


def fwd_launch(d: int, n: int, group_size: int) -> FwdLaunch:
    """What ``matmul_quant`` launches for x (., d) in G-blocks and y of n
    columns (``fwd::chunking`` and ``fwd::layout``)."""
    g = group_size
    chunk = d > 0 and d % g == 0 and g <= KCHUNK_MAX
    cw = (min(d, g * (KCHUNK_MAX // g), g * (KQB // KBM)) if chunk
          else min(d, KCHUNK_MAX))
    cw = max(cw, 1)
    _, nt, wn, kw, s = next(c for c in FWD_CONFIGS
                            if c[0] is None or n <= c[0])
    bn = 8 * nt * wn
    ws = bn + 8 if bn % 16 == 0 else bn
    xs = -(-cw // kw) * kw + 4
    area = KBM * xs + s * kw * ws
    batch = KQB
    if not chunk:
        area = max(area, g)
        batch = min(area // g, KQB)
    return FwdLaunch(chunk, cw, bn, batch, 4 * (area + 2 * batch))


def _padded(cols: int) -> int:
    return cols + 8 if cols % 16 == 0 else cols


def bwd_launch(m: int, d: int, n: int, group_size: int, bits: int,
               aligned: bool = True) -> BwdLaunch:
    """What ``dequant_matmul`` launches for an (m, d) stash of G-blocks and
    an (m, n) gradient, the packed words 16-byte aligned or not."""
    bd, bn, ks = fused_matmul.tile(n)
    r, maxw = BWD_RINGS[bn]
    s, rows = fused_matmul.splits(m, d, n)
    w = group_size // (32 // bits)
    ring = (d % group_size == 0 and group_size % bd == 0 and w % KRUN == 0
            and w <= maxw and aligned)
    buffers = 2 * KNB * 2 * ks * (_padded(bn) + _padded(bd))

    def smem(ring_on, words):
        return buffers + 4 * r * (ks * bn + (ks * words + 2 * ks
                                             if ring_on else 0))

    return BwdLaunch((bd, bn, ks), s, rows, ring, smem(ring, w),
                     smem(True, maxw), 4 * s * d * n if s > 1 else 0)


@dataclasses.dataclass(frozen=True)
class Contract:
    rule: str
    description: str
    applies: str                            # "fused" | "quant" | "rp"
    check: Callable[[Launch], str | None]   # violation message, or None


def _quant_precondition(e: Launch) -> str | None:
    return quant_blockwise.unsupported(e.bits, e.group_size, e.levels)


def _rp_precondition(e: Launch) -> str | None:
    if e.rp_ratio > 1 and e.d % e.rp_ratio:
        return (f"rp_matmul projects the last dim {e.d} by "
                f"rp_ratio={e.rp_ratio}, which does not divide it")
    return None


def _fused_precondition(e: Launch) -> str | None:
    return fused_matmul.unsupported(e.bits, e.group_size, e.levels)


def _block_alignment(e: Launch) -> str | None:
    g = e.group_size
    if (e.d % g and g % e.d) or (e.m * e.d) % g:
        return (f"the ({e.m}, {e.d}) operand is not whole G={g} blocks "
                "aligned to rows: a row tile would not own whole blocks")
    f = fwd_launch(e.d, e.n, g)
    if f.chunk_mode and (f.cw % g or KBM * (f.cw // g) > KQB):
        return (f"a chunk of {f.cw} columns is not whole blocks of {g} "
                f"within {KQB // KBM} a row")
    return None


def _fwd_smem(e: Launch) -> str | None:
    f = fwd_launch(e.d, e.n, e.group_size)
    if f.smem > fused_matmul.MAX_SMEM:
        return (f"the forward's CTA needs {f.smem} bytes of shared memory "
                f"(chunk {f.cw} columns, {f.bn} columns of y, a quantize "
                f"batch of {f.batch}) over MAX_SMEM={fused_matmul.MAX_SMEM}")
    return None


def _bwd_splits(e: Launch) -> str | None:
    b = bwd_launch(e.m, e.d, e.n, e.group_size, e.bits)
    ks = b.tile[2]
    if not 1 <= b.splits <= fused_matmul.MAX_SPLITS:
        return (f"{b.splits} row ranges, outside [1, "
                f"{fused_matmul.MAX_SPLITS}]")
    if b.rows % ks:
        return f"a range of {b.rows} rows is not whole stages of {ks}"
    if not (b.splits - 1) * b.rows < max(e.m, 1) <= b.splits * b.rows:
        return (f"{b.splits} ranges of {b.rows} rows do not cover the "
                f"{e.m} rows with none empty")
    return None


def _bwd_scratch(e: Launch) -> str | None:
    b = bwd_launch(e.m, e.d, e.n, e.group_size, e.bits)
    want = fused_matmul.scratch_nbytes(e.m, e.d, e.n)
    if b.scratch != want:
        return (f"the partials take {b.scratch} bytes ({b.splits} x "
                f"{e.d} x {e.n} floats) but the wrapper allocates {want}")
    return None


def _bwd_smem(e: Launch) -> str | None:
    for aligned in (True, False):
        b = bwd_launch(e.m, e.d, e.n, e.group_size, e.bits, aligned)
        if not b.smem <= b.max_smem <= SMEM_CAP:
            return (f"the backward's tile {b.tile} (ring {b.ring}) needs "
                    f"{b.smem} bytes of shared memory, set up for "
                    f"{b.max_smem}, over the card's {SMEM_CAP}")
    return None


CONTRACTS: tuple[Contract, ...] = (
    Contract("quant-precondition",
             "the quant kernels can run (bits | 32, at most 256 levels)",
             "quant", _quant_precondition),
    Contract("rp-precondition", "the ratio divides the stash width", "rp",
             _rp_precondition),
    Contract("quant-precondition",
             "the fused pair can run (whole words, at most 16 levels)",
             "fused", _fused_precondition),
    Contract("tile-block-alignment",
             "a row tile owns whole quantization blocks", "fused",
             _block_alignment),
    Contract("smem-budget", "the forward's CTA fits MAX_SMEM", "fused",
             _fwd_smem),
    Contract("bwd-splits",
             "at most MAX_SPLITS row ranges, each whole stages", "fused",
             _bwd_splits),
    Contract("bwd-scratch", "scratch is S * d * n floats", "fused",
             _bwd_scratch),
    Contract("smem-budget", "the backward's CTA fits 227 KiB", "fused",
             _bwd_smem),
)


def check_launch(e: Launch) -> list[Finding]:
    out = []
    for c in CONTRACTS:
        if c.applies != e.kind:
            continue
        msg = c.check(e)
        if msg is not None:
            out.append(Finding(PASS, c.rule, e.key, msg))
    return out


def check_launches(launches) -> list[Finding]:
    """Every contract over each distinct launch, in key order."""
    uniq = {e.key: e for e in launches}
    return [f for key in sorted(uniq) for f in check_launch(uniq[key])]


def layer_launches(comp, rows: int, lin_in: int, d_out: int,
                   fused: bool) -> list[Launch]:
    """The launches of one compressed layer's forward and backward over
    ``rows`` rows of a ``lin_in``-wide stash: the quant pair on its blocks
    (after RP when ``rp_ratio > 1``), RP and IRP, or the fused pair."""
    lv = comp.levels()
    d_eff = lin_in // comp.rp_ratio if comp.rp_ratio > 1 else lin_in
    if fused:
        return [Launch("fused", rows, lin_in, d_out, comp.bits,
                       comp.group_size, lv)]
    out = [Launch("quant", math.ceil(rows * d_eff / comp.group_size),
                  comp.group_size, comp.group_size, comp.bits,
                  comp.group_size, lv)]
    if comp.rp_ratio > 1:
        out.append(Launch("rp", rows, lin_in, max(1, d_eff), comp.bits,
                          comp.group_size, lv, comp.rp_ratio))
    return out


def matrix_launches() -> list[Launch]:
    """Every (layer config x width x rows) the plan matrix launches."""
    from repro_torch.graph.models import _dims
    from repro_torch.staticcheck.matrix import audit_matrix

    out = []
    for case in audit_matrix():
        dims = _dims(case.cfg, case.in_dim)
        for d_in, d_out, comp in zip(dims[:-1], dims[1:],
                                     case.cfg.layer_compression()):
            if comp is None:
                continue
            lin_in = d_in * (2 if case.cfg.arch == "sage" else 1)
            out += layer_launches(comp, case.live_nodes, lin_in, d_out,
                                  case.plan.kernel.fused == "on")
    return out


def run(launches=None) -> list[Finding]:
    """The contracts over the matrix's launches and ``launches``."""
    return check_launches(matrix_launches() + list(launches or ()))
