"""Tile selection for the fused pair (``repro_torch.kernels.autotune``) and
its cache's contracts (``staticcheck.kernel_contracts.check_autotune_cache``)
on the CPU: no kernel runs here, so the measurement (``autotune``) is left
to the card (``chip_smoke.py`` phase 16).

* Every candidate is legal: a compiled configuration that covers n and
  passes every launch contract.
* On a cache miss the roofline's pick is the fixed rule the kernels had
  (``fwd_index``, ``tile_index``, ``splits``) at every fused shape
  ``chip_smoke.py`` launches, so no phase moves on a machine without a
  cache.
* The cache round-trips, the hit and miss counters count (once per
  compiled step inside a ``StepTiles`` table), and the contracts flag an
  entry for a configuration the library lacks, one that does not cover
  its n, a split count that is not whole stages, an over-cap shared
  memory and a file that is not JSON.
"""
import json

import pytest

import chip_smoke
from repro_torch.kernels import autotune
from repro_torch.kernels import fused_matmul as fk
from repro_torch.obs.metrics import MetricsRegistry, set_metrics
from repro_torch.staticcheck import kernel_contracts as kc
from torch_threads import one_thread  # noqa: F401

BACKEND = "cuda:NVIDIA_H100_80GB_HBM3"
FUSED = [e for e in chip_smoke.smoke_launches() if e.kind == "fused"]


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "tiles.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.invalidate_cache()
    yield path
    autotune.invalidate_cache()


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_metrics(reg)
    yield reg
    set_metrics(prev)


@pytest.mark.parametrize("e", FUSED, ids=[e.key for e in FUSED])
def test_candidates_are_legal(e):
    fwd = autotune.fwd_candidates(e.m, e.d, e.n, e.group_size, e.bits)
    bwd = autotune.bwd_candidates(e.m, e.d, e.n, e.group_size, e.bits)
    assert fwd and bwd
    for c in fwd:
        assert kc.check_launch(kc.Launch("fused", e.m, e.d, e.n, e.bits,
                                         e.group_size, fwd_config=c)) == []
    for c, s in bwd:
        assert 1 <= s <= fk.MAX_SPLITS
        assert kc.check_launch(kc.Launch("fused", e.m, e.d, e.n, e.bits,
                                         e.group_size, bwd_config=c,
                                         bwd_splits=s)) == []
    # a configuration narrower than n is no candidate (the widest steps
    # over wide outputs in slabs)
    assert all(fk.fwd_columns(c) >= e.n or c == len(fk.FWD_CONFIGS) - 1
               for c in fwd)
    assert all(fk.TILES[c][1] >= e.n or c == len(fk.TILES) - 1
               for c, _ in bwd)


@pytest.mark.parametrize("e", FUSED, ids=[e.key for e in FUSED])
def test_miss_pick_is_the_fixed_rule_at_every_smoke_shape(e, cache,
                                                          registry):
    args = (e.m, e.d, e.n, e.bits, e.group_size, BACKEND)
    assert autotune.get_tiles("fwd", *args) == (fk.fwd_index(e.n),)
    assert autotune.get_tiles("bwd", *args) == (
        fk.tile_index(e.n), fk.splits(e.m, e.d, e.n)[0])
    assert registry.snapshot() == {"autotune/cache_miss": 2}


def test_cache_round_trips_and_counts_hits(cache, registry):
    e = FUSED[0]
    key = lambda kind: autotune.cache_key(kind, e.m, e.d, e.n, e.bits,
                                          e.group_size, BACKEND)
    cache.write_text(json.dumps({key("fwd"): [2], key("bwd"): [2, 7]}))
    args = (e.m, e.d, e.n, e.bits, e.group_size, BACKEND)
    assert autotune.get_tiles("fwd", *args) == (2,)
    assert autotune.get_tiles("bwd", *args) == (2, 7)
    # another card's entries are another backend's
    assert autotune.get_tiles("bwd", *args[:-1], "cuda:other") == \
        (fk.tile_index(e.n), fk.splits(e.m, e.d, e.n)[0])
    assert registry.snapshot() == {"autotune/cache_hit": 2,
                                   "autotune/cache_miss": 1}
    assert kc.check_autotune_cache(cache) == []


def test_step_table_resolves_once_per_compiled_step(cache, registry,
                                                    monkeypatch):
    monkeypatch.setattr(autotune, "backend_name", lambda device=None: BACKEND)
    table = autotune.StepTiles()
    for _ in range(3):
        with table:
            for kind in ("fwd", "bwd"):
                autotune.resolve(kind, 169_343, 512, 40, 2, 256)
                autotune.resolve(kind, 169_343, 256, 256, 2, 256)
    assert registry.snapshot() == {"autotune/cache_miss": 4}
    assert len(table.choices) == 4
    # outside a table every launch resolves
    autotune.resolve("fwd", 169_343, 512, 40, 2, 256)
    assert registry.snapshot() == {"autotune/cache_miss": 5}


def test_cpu_wrappers_resolve_nothing(registry):
    import torch

    x, w = torch.randn(4, 256), torch.randn(256, 8)
    y, packed, zero, rng = fk.matmul_quant(x, w, 2, 3, group_size=256)
    fk.dequant_matmul(packed, zero, rng, torch.randn(4, 8), 2, 256, 256)
    assert registry.snapshot() == {}


def _entry(kind, m=169_343, d=512, n=256, g=256):
    return autotune.cache_key(kind, m, d, n, 2, g, BACKEND)


@pytest.mark.parametrize("entries,rule", [
    ({_entry("fwd"): [3]}, "tile-config"),
    ({_entry("bwd"): [-1, 4]}, "tile-config"),
    ({_entry("fwd"): [0]}, "tile-config"),              # 40 columns < 256
    ({_entry("bwd", n=64): [0, 4]}, "tile-config"),
    ({_entry("bwd"): [2, 65]}, "bwd-splits"),          # over MAX_SPLITS
    ({_entry("bwd", m=100): [2, 3]}, "bwd-splits"),     # not whole stages
    ({"fwd/169343x512/b2/g256/x": [2]}, "cache-key"),
    ({_entry("fwd"): [2, 1]}, "cache-key"),
    ({_entry("fwd"): "2"}, "cache-key"),
])
def test_cache_contracts_flag_a_bad_entry(cache, entries, rule):
    cache.write_text(json.dumps(entries))
    got = kc.check_autotune_cache(cache)
    assert [f.rule for f in got] == [rule]
    assert got[0].where == next(iter(entries)) or rule == "cache-key"


def test_cache_contracts_flag_over_cap_shared_memory(cache, monkeypatch):
    cache.write_text(json.dumps({_entry("fwd"): [2],
                                 _entry("bwd"): [2, 16]}))
    assert kc.check_autotune_cache(cache) == []
    monkeypatch.setattr(kc, "SMEM_CAP", 200_000)
    got = kc.check_autotune_cache(cache)
    assert [(f.rule, f.where) for f in got] == [("smem-budget",
                                                 _entry("bwd"))]
    assert "227 KiB" in kc.CONTRACTS[-1].description


def test_cache_contracts_flag_bad_json(cache):
    cache.write_text("{not json")
    got = kc.check_autotune_cache(cache)
    assert [f.rule for f in got] == ["cache-key"]
    assert "not valid JSON" in got[0].message
    assert kc.check_autotune_cache(cache.parent / "absent.json") == []


def test_kernel_contracts_pass_reads_the_cache(cache):
    cache.write_text(json.dumps({_entry("fwd"): [7]}))
    assert [f.rule for f in kc.run()] == ["tile-config"]
