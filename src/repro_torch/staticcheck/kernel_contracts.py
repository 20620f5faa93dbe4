"""Declarative pre/post-conditions for the compression kernels, stated
over the CUDA launch configurations the port computes (the reference's
``repro.staticcheck.kernel_contracts``, whose TPU VMEM budget has no
counterpart here), and over every entry of the tile cache
(:mod:`repro_torch.kernels.autotune`).

A :class:`Launch` is one kernel call the main path makes: its kind
(``quant``, ``rp``, ``fused``), its shape, its quantization config and,
for the fused pair, the compiled configuration each kernel runs and the
backward's split count (default: the fixed rule).
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
  the predicate the dispatch layer routes on, and a shard's block offset
  (``row0`` and the column split's ``block_stride``):
  :func:`~repro_torch.kernels.quant_blockwise.offset_unsupported`, the
  rule ``quant_pack`` checks its launch arguments by;
* ``rp_matmul``: the projection ratio divides the stash width.

:func:`run` checks every (layer config x width x rows) the plan matrix
launches; :func:`check_launches` takes any other list (``chip_smoke.py``
checks the shapes it launches on the card, and the tests hold them
clean).  :func:`check_autotune_cache` checks every entry of the tile
cache: it parses, names a compiled configuration that covers its n, and
every contract holds for the launch it names.  A gpu test holds
:func:`fwd_launch` and :func:`bwd_launch`'s shared memory equal to the
kernel library's own ``matmul_quant_smem`` / ``dequant_matmul_smem`` for
each configuration.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
from typing import Callable

from repro_torch.kernels import fused_matmul, quant_blockwise
from repro_torch.staticcheck.findings import Finding

PASS = "kernel-contracts"

#: The card's shared memory a CTA may opt into (H100: 227 KiB).
SMEM_CAP = 232_448

# csrc/fused_matmul.cu, namespace fwd: rows of x a CTA, columns of x a
# chunk at most, blocks a quantize batch at most
KBM, KCHUNK_MAX, KQB = fused_matmul.FWD_ROWS, 256, 256

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
    fwd_config: int | None = None     # None: fused_matmul.fwd_index(n)
    bwd_config: int | None = None     # None: fused_matmul.tile_index(n)
    bwd_splits: int | None = None     # None: fused_matmul.splits' rule
    row0: int = 0                     # quant: the first block's global index
    block_stride: tuple | None = None  # quant: (blocks a local row, global)

    @property
    def key(self) -> str:
        vm = f"/vm{len(self.levels)}" if self.levels else ""
        off = (f"/at{self.row0}" if self.row0 else "") + (
            "/stride{}x{}".format(*self.block_stride)
            if self.block_stride else "")
        return (f"{self.kind}/{self.m}x{self.d}x{self.n}/b{self.bits}"
                f"/g{self.group_size}{vm}{off}")


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


def fwd_launch(d: int, n: int, group_size: int,
               config: int | None = None) -> FwdLaunch:
    """What ``matmul_quant`` launches for x (., d) in G-blocks, y of n
    columns and configuration ``config`` (default: the fixed rule)
    (``fwd::chunking`` and ``fwd::layout``)."""
    g = group_size
    chunk = d > 0 and d % g == 0 and g <= KCHUNK_MAX
    cw = (min(d, g * (KCHUNK_MAX // g), g * (KQB // KBM)) if chunk
          else min(d, KCHUNK_MAX))
    cw = max(cw, 1)
    if config is None:
        config = fused_matmul.fwd_index(n)
    nt, wn, _, kw, s, _ = fused_matmul.FWD_CONFIGS[config]
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
               aligned: bool = True, config: int | None = None,
               n_splits: int | None = None) -> BwdLaunch:
    """What ``dequant_matmul`` launches for an (m, d) stash of G-blocks and
    an (m, n) gradient, the packed words 16-byte aligned or not, with tile
    ``config`` over ``n_splits`` ranges (defaults: the fixed rules)."""
    if config is None:
        bd, bn, ks = fused_matmul.tile(n)
    else:
        bd, bn, ks = fused_matmul.TILES[config]
    r, maxw = BWD_RINGS[bn]
    s, rows = fused_matmul.splits(m, d, n, config, n_splits)
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
    side: str = "both"                      # the fused pair's "fwd" | "bwd"


def _quant_precondition(e: Launch) -> str | None:
    return quant_blockwise.unsupported(e.bits, e.group_size, e.levels)


def _quant_offset(e: Launch) -> str | None:
    return quant_blockwise.offset_unsupported(e.m, e.row0, e.block_stride)


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
    f = fwd_launch(e.d, e.n, g, e.fwd_config)
    if f.chunk_mode and (f.cw % g or KBM * (f.cw // g) > KQB):
        return (f"a chunk of {f.cw} columns is not whole blocks of {g} "
                f"within {KQB // KBM} a row")
    return None


def _tile_config(e: Launch) -> str | None:
    """The configurations named are compiled and cover n."""
    for what, config, table, width in (
            ("forward configuration", e.fwd_config, fused_matmul.FWD_CONFIGS,
             fused_matmul.fwd_columns),
            ("backward tile", e.bwd_config, fused_matmul.TILES,
             lambda i: fused_matmul.TILES[i][1])):
        if config is None:
            continue
        if not 0 <= config < len(table):
            return (f"no compiled {what} {config} (the library has "
                    f"{len(table)})")
        widest = max(width(i) for i in range(len(table)))
        if not fused_matmul.covers(width(config), e.n, widest):
            return (f"{what} {config} spans {width(config)} columns and "
                    f"is not the widest: it does not cover n={e.n}")
    if e.bwd_splits is not None and e.bwd_splits < 1:
        return f"a split count of {e.bwd_splits}"
    return None


def _fwd_smem(e: Launch) -> str | None:
    f = fwd_launch(e.d, e.n, e.group_size, e.fwd_config)
    if f.smem > fused_matmul.MAX_SMEM:
        return (f"the forward's CTA needs {f.smem} bytes of shared memory "
                f"(chunk {f.cw} columns, {f.bn} columns of y, a quantize "
                f"batch of {f.batch}) over MAX_SMEM={fused_matmul.MAX_SMEM}")
    return None


def _bwd(e: Launch, aligned: bool = True) -> BwdLaunch:
    return bwd_launch(e.m, e.d, e.n, e.group_size, e.bits, aligned,
                      e.bwd_config, e.bwd_splits)


def _bwd_splits(e: Launch) -> str | None:
    b = _bwd(e)
    ks = b.tile[2]
    if not 1 <= b.splits <= fused_matmul.MAX_SPLITS:
        return (f"{b.splits} row ranges, outside [1, "
                f"{fused_matmul.MAX_SPLITS}]")
    if b.rows % ks:
        return f"a range of {b.rows} rows is not whole stages of {ks}"
    if not (b.splits - 1) * b.rows < max(e.m, 1) <= b.splits * b.rows:
        return (f"{b.splits} ranges of {b.rows} rows do not cover the "
                f"{e.m} rows with none empty")
    if e.bwd_splits is not None and b.splits != e.bwd_splits:
        return (f"S={e.bwd_splits} is not whole stages of {ks} rows: the "
                f"launch makes {b.splits} ranges")
    return None


def _bwd_scratch(e: Launch) -> str | None:
    b = _bwd(e)
    want = fused_matmul.scratch_nbytes(e.m, e.d, e.n, e.bwd_config,
                                       e.bwd_splits)
    if b.scratch != want:
        return (f"the partials take {b.scratch} bytes ({b.splits} x "
                f"{e.d} x {e.n} floats) but the wrapper allocates {want}")
    return None


def _bwd_smem(e: Launch) -> str | None:
    for aligned in (True, False):
        b = _bwd(e, aligned)
        if not b.smem <= b.max_smem <= SMEM_CAP:
            return (f"the backward's tile {b.tile} (ring {b.ring}) needs "
                    f"{b.smem} bytes of shared memory, set up for "
                    f"{b.max_smem}, over the card's {SMEM_CAP}")
    return None


CONTRACTS: tuple[Contract, ...] = (
    Contract("quant-precondition",
             "the quant kernels can run (bits | 32, at most 256 levels)",
             "quant", _quant_precondition),
    Contract("quant-offset",
             "a shard's block offset is whole local rows of 1 <= local <= "
             "global blocks", "quant", _quant_offset),
    Contract("rp-precondition", "the ratio divides the stash width", "rp",
             _rp_precondition),
    Contract("quant-precondition",
             "the fused pair can run (whole words, at most 16 levels)",
             "fused", _fused_precondition),
    Contract("tile-config",
             "each kernel runs a compiled configuration that covers n",
             "fused", _tile_config),
    Contract("tile-block-alignment",
             "a row tile owns whole quantization blocks", "fused",
             _block_alignment),
    Contract("smem-budget", "the forward's CTA fits MAX_SMEM", "fused",
             _fwd_smem, "fwd"),
    Contract("bwd-splits",
             "at most MAX_SPLITS row ranges, each whole stages", "fused",
             _bwd_splits, "bwd"),
    Contract("bwd-scratch", "scratch is S * d * n floats", "fused",
             _bwd_scratch, "bwd"),
    Contract("smem-budget", "the backward's CTA fits 227 KiB", "fused",
             _bwd_smem, "bwd"),
)


def check_launch(e: Launch, where: str | None = None,
                 side: str = "both") -> list[Finding]:
    """Every contract of ``e``'s kind, of the fused pair's ``side``
    ("fwd", "bwd" or "both"; none past a ``tile-config`` finding: the
    configuration they would read does not exist)."""
    out = []
    for c in CONTRACTS:
        if c.applies != e.kind or "both" not in (side, c.side) \
                and side != c.side:
            continue
        msg = c.check(e)
        if msg is not None:
            out.append(Finding(PASS, c.rule, where or e.key, msg))
            if c.rule == "tile-config":
                break
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


# ------------------------------------------------------------ tile cache
_KEY_RE = re.compile(r"^(?P<kind>fwd|bwd)/(?P<m>\d+)x(?P<d>\d+)x(?P<n>\d+)"
                     r"/b(?P<bits>\d+)/g(?P<group>\d+)/(?P<backend>[^/]+)$")


def entry_launch(key: str, choice) -> Launch | None:
    """The launch a tile-cache entry names (None if it does not parse):
    ``fwd/...`` -> ``[config]``, ``bwd/...`` -> ``[config, S]``; its
    ``side`` is the key's kind."""
    m = _KEY_RE.match(key)
    if m is None or not isinstance(choice, (list, tuple)) \
            or not all(isinstance(v, int) for v in choice):
        return None
    shape = (int(m["m"]), int(m["d"]), int(m["n"]), int(m["bits"]),
             int(m["group"]))
    if m["kind"] == "fwd" and len(choice) == 1:
        return Launch("fused", *shape, fwd_config=choice[0])
    if m["kind"] == "bwd" and len(choice) == 2:
        return Launch("fused", *shape, bwd_config=choice[0],
                      bwd_splits=choice[1])
    return None


def check_autotune_cache(path: pathlib.Path | None = None) -> list[Finding]:
    """Every contract over every entry of the tile cache at ``path``
    (default: :func:`repro_torch.kernels.autotune.cache_path`)."""
    if path is None:
        from repro_torch.kernels.autotune import cache_path

        path = cache_path()
    p = pathlib.Path(path)
    if not p.exists():
        return []
    try:
        cache = json.loads(p.read_text())
    except (ValueError, OSError) as e:
        return [Finding(PASS, "cache-key", str(p),
                        f"tile cache is not valid JSON: {e}")]
    if not isinstance(cache, dict):
        return [Finding(PASS, "cache-key", str(p),
                        "tile cache is not a JSON object")]
    out = []
    for key in sorted(cache):
        e = entry_launch(key, cache[key])
        if e is None:
            out.append(Finding(PASS, "cache-key", key,
                               f"unparseable tile-cache entry "
                               f"({cache[key]!r}); expected kind/MxDxN/"
                               "bBITS/gG/backend -> [config] (fwd) or "
                               "[config, S] (bwd)"))
        else:
            out.extend(check_launch(e, where=key, side=key[:3]))
    return out


def run(launches=None, cache: pathlib.Path | None = None) -> list[Finding]:
    """The contracts over the tile cache, the matrix's launches and
    ``launches``."""
    return check_autotune_cache(cache) + check_launches(
        matrix_launches() + list(launches or ()))
