"""Tile selection for the fused matmul-quant pair (the reference's
``repro.kernels.autotune``).

Each kernel of the pair has three compiled CTA configurations
(``csrc/fused_matmul.cu``: ``kFwd`` for the forward, ``kTiles`` for the
backward, :data:`~repro_torch.kernels.fused_matmul.FWD_CONFIGS` /
``TILES`` here), and the backward a split count S of its row contraction.
A choice is a configuration index (forward) or an index and S (backward).
Two layers:

* a **roofline of the H100** ranks the legal candidates: the larger of the
  bytes a candidate moves over :data:`PEAK_BYTES_PER_S` and its operations
  over the tensor cores' peak (the forward's three split TF32 products,
  the backward's three split bf16 ones, over the columns a CTA pads to),
  divided by the share of its waves of :data:`~repro_torch.kernels.
  fused_matmul.TARGET_CTAS` CTAs (one an SM) that it fills.  The bytes count what each candidate
  re-reads: x once a column slab and w once a row tile (forward), the
  stash once a column tile and g once a row tile of dw (backward), and the
  partials written and read back when S > 1.  No TPU constant carries
  over;
* a **measurement** (:func:`autotune`) times the candidates with CUDA
  events, the L2 flushed before every launch, and persists the winners in
  a JSON cache keyed ``kind/MxDxN/bBITS/gG/backend`` (the backend names
  the card): ``results/autotune/fused_tiles_cuda.json`` by default,
  overridable by ``REPRO_TORCH_AUTOTUNE_CACHE``, a file of its own so
  that the reference's cache readers never see these entries.

:func:`get_tiles` is the read path: on a cache hit the cached choice
(counting ``autotune/cache_hit`` on the active metrics registry), on a
miss the roofline's best legal pick (counting ``autotune/cache_miss``).
On a miss that pick is the fixed rule the kernels had before
(:func:`~repro_torch.kernels.fused_matmul.fwd_index`, ``tile_index``,
``splits``) at every shape the port launches.  It never measures.

The reference resolves tiles once a trace.  The port runs eagerly, so a
compiled step owns a :class:`StepTiles` table: inside ``with table:`` the
wrappers resolve each shape once, on its first launch, and every later
launch of the step reads the table, so the counters count resolutions
once per compiled step, not once per launch.  Outside a table every
launch resolves (and counts).

A candidate whose bits differ from the default's (another S, or another
tile of the backward, changes the order of the sum; a forward
configuration whose ``y`` differs) is persisted only on a measured win of
more than 10 %, as the reference persists a split backward.
"""
from __future__ import annotations

import functools
import json
import math
import os
import pathlib

from repro_torch.kernels import fused_matmul as fk

_REPO = pathlib.Path(__file__).resolve().parents[3]
_DEFAULT_CACHE = _REPO / "results" / "autotune" / "fused_tiles_cuda.json"

#: The H100's device memory rate, and its dense TF32 and bf16 tensor-core
#: peaks (``chip_smoke.py``'s bound table).
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_OPS_PER_S = 495e12
PEAK_BF16_OPS_PER_S = 989e12
#: Products a kernel runs for one float32 product (hi/lo splits).
SPLIT_PRODUCTS = 3
#: A candidate that changes the bits persists only this far below the
#: default's time.
WIN = 0.9


def _cache_file() -> str:
    return os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE", str(_DEFAULT_CACHE))


def cache_path() -> pathlib.Path:
    return pathlib.Path(_cache_file())


def backend_name(device=None) -> str:
    """The cache key's backend: ``cuda:<the card's name>`` (spaces as
    underscores)."""
    import torch

    return _card(torch.cuda.current_device() if device is None
                 else torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> str:
    import torch

    return "cuda:" + torch.cuda.get_device_name(index).replace(" ", "_")


def cache_key(kind: str, m: int, d: int, n: int, bits: int, group_size: int,
              backend: str) -> str:
    return f"{kind}/{m}x{d}x{n}/b{bits}/g{group_size}/{backend}"


@functools.lru_cache(maxsize=4)
def _load(path: str) -> dict:
    p = pathlib.Path(path)
    return json.loads(p.read_text()) if p.exists() else {}


def load_cache() -> dict:
    """The cache at :func:`cache_path` (empty when there is none; a file
    that is not JSON raises)."""
    return _load(_cache_file())


def invalidate_cache() -> None:
    _load.cache_clear()


# ------------------------------------------------------------ candidates
def _legal(m, d, n, bits, group_size, side, **config) -> bool:
    from repro_torch.staticcheck import kernel_contracts as kc

    return not kc.check_launch(kc.Launch("fused", m, d, n, bits, group_size,
                                         **config), side=side)


def fwd_candidates(m: int, d: int, n: int, group_size: int,
                   bits: int = 2) -> list[int]:
    """Forward configurations that cover n and pass the launch contracts."""
    widest = max(fk.fwd_columns(i) for i in range(len(fk.FWD_CONFIGS)))
    return [i for i in range(len(fk.FWD_CONFIGS))
            if fk.covers(fk.fwd_columns(i), n, widest)
            and _legal(m, d, n, bits, group_size, "fwd", fwd_config=i)]


def bwd_candidates(m: int, d: int, n: int, group_size: int,
                   bits: int = 2) -> list[tuple[int, int]]:
    """(tile, S) pairs for the backward: tiles that cover n and pass the
    launch contracts, each with every split count up to ``MAX_SPLITS``
    that whole stages of the tile give."""
    widest = max(t[1] for t in fk.TILES)
    out = []
    for i, (_, bn, _) in enumerate(fk.TILES):
        if not fk.covers(bn, n, widest):
            continue
        counts = sorted({fk.splits(m, d, n, i, s)[0]
                         for s in range(1, fk.MAX_SPLITS + 1)})
        out += [(i, s) for s in counts
                if _legal(m, d, n, bits, group_size, "bwd", bwd_config=i,
                          bwd_splits=s)]
    return out


# --------------------------------------------------------------- roofline
def _busy(ctas: int) -> float:
    """The share of its waves' CTA slots a launch fills, the card taken as
    waves of TARGET_CTAS CTAs (one an SM)."""
    return ctas / (math.ceil(ctas / fk.TARGET_CTAS) * fk.TARGET_CTAS)


def fwd_cost(m: int, d: int, n: int, config: int, bits: int = 2,
             group_size: int = 256) -> tuple[float, float, float]:
    """(predicted ms, bytes, operations) of the forward with ``config``."""
    bn = fk.fwd_columns(config)
    slabs, tiles = math.ceil(n / bn), math.ceil(m / fk.FWD_ROWS)
    ops = 2.0 * m * d * slabs * bn * SPLIT_PRODUCTS
    nbytes = (4.0 * m * d * slabs + 4.0 * d * n * tiles + 4.0 * m * n
              + m * d * bits / 8 + 8.0 * m * d / group_size)
    t = max(ops / PEAK_TF32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
    return t / _busy(tiles * slabs) * 1e3, nbytes, ops


def bwd_cost(m: int, d: int, n: int, config: int, s: int, bits: int = 2,
             group_size: int = 256) -> tuple[float, float, float]:
    """(predicted ms, bytes, operations) of the backward with tile
    ``config`` over ``s`` row ranges."""
    bd, bn, _ = fk.TILES[config]
    row_tiles, col_tiles = math.ceil(d / bd), math.ceil(n / bn)
    ops = 2.0 * m * row_tiles * bd * col_tiles * bn * SPLIT_PRODUCTS
    stash = m * d * bits / 8 + 8.0 * m * d / group_size
    nbytes = stash * col_tiles + 4.0 * m * n * row_tiles + 4.0 * d * n
    if s > 1:
        nbytes += 2 * 4.0 * s * d * n
    t = max(ops / PEAK_BF16_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
    return t / _busy(row_tiles * col_tiles * s) * 1e3, nbytes, ops


@functools.lru_cache(maxsize=None)
def roofline_pick(kind: str, m: int, d: int, n: int, bits: int,
                  group_size: int) -> tuple:
    """The legal candidate the roofline ranks first (ties: fewer bytes,
    then fewer operations).  Kept per shape: a wrapper called outside a
    step's table resolves every launch, and the candidates' contracts
    cost milliseconds of host time."""
    if kind == "fwd":
        cands = fwd_candidates(m, d, n, group_size, bits)
        return (min(cands, key=lambda c: fwd_cost(m, d, n, c, bits,
                                                  group_size)),)
    cands = bwd_candidates(m, d, n, group_size, bits)
    return min(cands, key=lambda c: bwd_cost(m, d, n, *c, bits, group_size))


# ------------------------------------------------------------- read path
def get_tiles(kind: str, m: int, d: int, n: int, bits: int, group_size: int,
              backend: str | None = None) -> tuple:
    """The choice for one fused call: ``(config,)`` for ``"fwd"``,
    ``(config, S)`` for ``"bwd"``; the cache's on a hit, else
    :func:`roofline_pick`'s.  Counts ``autotune/cache_hit`` or
    ``autotune/cache_miss``."""
    from repro_torch.obs.metrics import get_metrics

    backend = backend or backend_name()
    hit = load_cache().get(cache_key(kind, m, d, n, bits, group_size,
                                     backend))
    if hit:
        get_metrics().counter("autotune/cache_hit").inc()
        return tuple(int(v) for v in hit)
    get_metrics().counter("autotune/cache_miss").inc()
    return roofline_pick(kind, m, d, n, bits, group_size)


class StepTiles:
    """A compiled step's table of resolved choices: ``with table:`` makes
    it the one the wrappers read (see the module docstring).  A plain
    module global, not a context variable: the backward's launches run on
    autograd's device thread."""

    def __init__(self):
        self.choices: dict = {}
        self._prev = None

    def __enter__(self):
        global _ACTIVE
        self._prev, _ACTIVE = _ACTIVE, self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev


_ACTIVE: StepTiles | None = None


def resolve(kind: str, m: int, d: int, n: int, bits: int,
            group_size: int) -> tuple:
    """The wrappers' choice: the active :class:`StepTiles` table's, or a
    fresh :func:`get_tiles` (stored in the table when one is active)."""
    table = _ACTIVE
    key = (kind, m, d, n, bits, group_size)
    if table is not None and key in table.choices:
        return table.choices[key]
    got = get_tiles(kind, m, d, n, bits, group_size)
    if table is not None:
        table.choices[key] = got
    return got


# ------------------------------------------------------------ measurement
def autotune(cases, *, repeats: int = 10, top: int = 8, write: bool = True,
             log: list | None = None) -> dict:
    """Time the fused pair's candidates on the card and persist the
    winners; returns the updated cache.

    ``cases``: ``(m, d, n, bits, group_size)`` tuples.  Each case times
    every forward candidate and the roofline's ``top`` backward candidates
    (the default always among them), each the median of ``repeats``
    launches between CUDA events with the L2 flushed first.  ``log`` gets
    one row a candidate: kind, shape, choice, ms, the roofline's ms,
    whether its output is the default's bit for bit, and whether it won."""
    import statistics

    import torch

    backend = backend_name()
    cache = dict(load_cache())
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32,
                        device="cuda")

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def pick(kind, shape, default, rows):
        """The fastest row, unless it changes the bits and wins by no
        more than WIN."""
        best = min(rows, key=lambda r: r["ms"])
        base = next(r for r in rows if r["choice"] == default)
        if not best["bit_equal"] and not best["ms"] < WIN * base["ms"]:
            best = base
        for r in rows:
            r["won"] = r is best
            if log is not None:
                log.append({"kind": kind, "shape": shape, **r})
        return best["choice"]

    for (m, d, n, bits, g) in cases:
        shape = (m, d, n, bits, g)
        x = torch.randn((m, d), generator=gen, device="cuda")
        w = torch.randn((d, n), generator=gen, device="cuda") / d ** 0.5
        gr = torch.randn((m, n), generator=gen, device="cuda")
        default = roofline_pick("fwd", m, d, n, bits, g)
        y0, packed, zero, rng = fk.matmul_quant(x, w, bits, 7, None,
                                                group_size=g,
                                                config=default[0])
        rows = []
        for c in fwd_candidates(m, d, n, g, bits):
            y = fk.matmul_quant(x, w, bits, 7, None, group_size=g,
                                config=c)[0]
            rows.append({"choice": (c,), "bit_equal": bool(torch.equal(y, y0)),
                         "bound_ms": fwd_cost(m, d, n, c, bits, g)[0],
                         "ms": time_ms(lambda c=c: fk.matmul_quant(
                             x, w, bits, 7, None, group_size=g, config=c))})
        cache[cache_key("fwd", m, d, n, bits, g, backend)] = \
            list(pick("fwd", shape, default, rows))

        default = roofline_pick("bwd", m, d, n, bits, g)
        ranked = sorted(bwd_candidates(m, d, n, g, bits),
                        key=lambda c: bwd_cost(m, d, n, *c, bits, g))
        chosen = [default] + [c for c in ranked if c != default][:top - 1]
        dw0 = fk.dequant_matmul(packed, zero, rng, gr, bits, g, d,
                                config=default[0], n_splits=default[1])
        rows = []
        for c, s in chosen:
            def call(c=c, s=s):
                return fk.dequant_matmul(packed, zero, rng, gr, bits, g, d,
                                         config=c, n_splits=s)
            rows.append({"choice": (c, s),
                         "bit_equal": bool(torch.equal(call(), dw0)),
                         "bound_ms": bwd_cost(m, d, n, c, s, bits, g)[0],
                         "ms": time_ms(call)})
        cache[cache_key("bwd", m, d, n, bits, g, backend)] = \
            list(pick("bwd", shape, default, rows))
        del x, w, gr, y0, packed, zero, rng, dw0
    if write:
        p = cache_path()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(cache, indent=2, sort_keys=True) + "\n")
        invalidate_cache()
    return cache
