"""The work counts and peaks against hand-reckoned values at tiny shapes,
and the benchmark's reckoning of the stash against the program's counter."""
import pytest

from portbench.bench import peaks
from portbench.bench.harness import Registry
from portbench.bench.window import p95
from portbench.bench.work import GNNStep

# 10 nodes, 30 edges, SAGE 4 -> 8 -> 3
RP = {"bits": 2, "group_size": 16, "rp_ratio": 2, "vm": True}
NO_RP = {"bits": 2, "group_size": 16, "rp_ratio": 0, "vm": True}


def _step(recipe):
    return GNNStep(10, 30, (4, 8, 3), recipe)


def test_model_flops():
    # layer 0: aggregate 2*30*4, linear 2*10*8*8, dW 2*10*8*8
    # layer 1: aggregate 2*30*8, linear 2*10*16*3, dW the same,
    #          dX 2*10*3*16, transposed aggregate 2*30*8
    want = (240 + 1280 + 1280) + (480 + 960 + 960 + 960 + 480)
    assert _step(None).model_flops() == want


def test_stash_bytes():
    # float32: 10*8*4 + mask ceil(10*8/32)*4 = 320 + 12; 10*16*4 = 640
    assert _step(None).stash_bytes() == [332, 640]
    # RP 2: layer 0 projects 8 -> 4 columns, 40 values = 3 blocks of 16 of
    # one word each: 3*4 + 3*8 + 4 = 40, + mask 12; layer 1 16 -> 8: 80 =
    # 5 blocks: 5*4 + 5*8 + 4 = 64
    assert _step(RP).stash_bytes() == [52, 64]
    # no RP: 80 values = 5 blocks, 160 = 10 blocks
    assert _step(NO_RP).stash_bytes() == [5 * 12 + 4 + 12, 10 * 12 + 4]


def test_fused_and_quant_layers():
    assert [ly.index for ly in _step(NO_RP).fused_layers()] == [0, 1]
    assert _step(NO_RP).quant_layers() == []
    assert _step(RP).fused_layers() == []
    assert [ly.index for ly in _step(RP).quant_layers()] == [0, 1]
    assert GNNStep(10, 30, (4, 8, 3), NO_RP, "off").fused_layers() == []
    # 2-bit codes of 8 fill half a word: no fused pair
    half = dict(NO_RP, group_size=8)
    assert _step(half).fused_layers() == []


def _metric(name):
    from pathlib import Path
    return Registry(Path(__file__).resolve().parents[1]).metric(name)


def test_quant_bound():
    # layer 0: 3 blocks: 3*16*4 floats + 3*(4 + 8) codes = 228 bytes, each
    # way; layer 1: 5 blocks: 320 + 60 = 380
    want = 2 * (228 + 380) / peaks.HBM_BYTES_S
    assert _metric("quant_roofline").bound_s(_step(RP)) == pytest.approx(
        want, rel=1e-12)


def test_rp_bound():
    # layer 0: 10 rows 8 -> 4: bytes 4*10*12, flops 2*10*8*4; layer 1
    # 16 -> 8: 4*10*24, 2*10*16*8; projection and recovery alike
    want = 2 * (max(480 / peaks.HBM_BYTES_S, 640 / peaks.TF32_FLOPS)
                + max(960 / peaks.HBM_BYTES_S, 2560 / peaks.TF32_FLOPS))
    assert _metric("rp_roofline").bound_s(_step(RP)) == pytest.approx(
        want, rel=1e-12)
    assert _metric("rp_roofline").bound_s(_step(NO_RP)) == 0.0


def test_fused_bound():
    # layer 0: x 10x8, w 8x8, y 10x8, 5 blocks of one word; layer 1: x
    # 10x16, w 16x3, y 10x3, 10 blocks
    f0, f1 = 2 * 10 * 8 * 8, 2 * 10 * 16 * 3
    fwd0 = 4 * (80 + 64 + 80) + 60
    bwd0 = 60 + 4 * (80 + 64)
    fwd1 = 4 * (160 + 48 + 30) + 120
    bwd1 = 120 + 4 * (30 + 48)
    b = peaks.bound_s
    want = (b(fwd0, f0, peaks.TF32_FLOPS) + b(bwd0, f0, peaks.TF32_FLOPS)
            + b(fwd1, f1, peaks.TF32_FLOPS) + b(bwd1, f1, peaks.TF32_FLOPS))
    assert _metric("fused_roofline").bound_s(_step(NO_RP)) == pytest.approx(
        want, rel=1e-12)


def test_peaks_are_the_data_sheets():
    assert (peaks.HBM_BYTES_S, peaks.FP32_FLOPS, peaks.TF32_FLOPS) == (
        3.35e12, 67e12, 495e12)


def test_p95_nearest_rank():
    assert p95(list(range(1, 101))) == 95
    assert p95([3.0]) == 3.0


@pytest.mark.parametrize("workload", ["sage-arxiv.iexact",
                                      "sage-flickr.iexact", "sage-arxiv.rp0",
                                      "sage-arxiv.fp32"])
def test_stash_reckoning_is_the_programs(tiny, workload):
    bench, base = tiny
    reg = Registry(base)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = reg.config(cell["config"])
    drv = reg.driver(config["driver"]).Driver(
        config, reg.traffic(cell["traffic"]), 3, "cpu", {})
    drv.setup(0)
    assert drv.counters()["stash_bytes"] == drv.shapes().stash_bytes()
