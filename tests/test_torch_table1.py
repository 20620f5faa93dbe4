"""The paper's Table 1 on the port, on the CPU, against the JAX reference:
the flickr stand-in and ``in_adjacency``, per-layer ``GNNConfig`` tuples,
the whole-tensor ``quantize`` / ``dequantize``, the plain quant path at the
ragged group sizes of Table 1's flickr rows and at 8-bit VM, the byte
ledger ``activation_memory_report``, 8-bit AdamW states, and the flickr
rows trained end to end.

Setup: flickr-like at scale 0.006 (535 nodes, 500 features, 7 classes),
SAGE hidden (32, 32); the layer-0 stash is 535 x 125 after RP 8, so G = 125
is one block a row and G = 1000 straddles rows with a ragged tail.
Tolerances: byte ledgers, widths, packed words, zero and range exactly;
losses rtol 1e-3 (the matmuls and the aggregation sum in another order
than XLA, and a last-ulp difference can flip a rare SR code); AdamW
params rtol 1e-6 (``b ** t`` is numpy's float32 power here, XLA's there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as j_backend
from repro.core import quant as j_quant
from repro.core.compressor import CompressionConfig as JCC
from repro.graph.data import flickr_like as j_flickr_like
from repro.graph.data import in_adjacency as j_in_adjacency
from repro.graph.models import GNNConfig as JCfg
from repro.graph.models import init_gnn_params
from repro.graph.train import activation_memory_report as j_report
from repro.graph.train import train_gnn as j_train_gnn
from repro.optim import AdamWConfig as JAdam
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.core import quant as t_quant
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.core.variance import optimize_levels
from repro_torch.engine.plan import ExecutionPlan
from repro_torch.graph.analysis import live_stash_bytes
from repro_torch.graph.data import flickr_like as t_flickr_like
from repro_torch.graph.data import in_adjacency as t_in_adjacency
from repro_torch.graph.models import GNNConfig as TCfg
from repro_torch.graph.models import params_from_numpy
from repro_torch.graph.train import activation_memory_report as t_report
from repro_torch.graph.train import train_gnn as t_train_gnn
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import quant_blockwise as t_qk
from repro_torch.optim import AdamWConfig as TAdam
from repro_torch.optim import adamw_init as t_adamw_init
from repro_torch.optim import adamw_update as t_adamw_update
from torch_threads import one_thread  # noqa: F401

SCALE = 0.006
HIDDEN = (32, 32)


@functools.lru_cache(maxsize=None)
def _graphs():
    return j_flickr_like(scale=SCALE), t_flickr_like(scale=SCALE)


def _both(comp):
    """The same compression spec as a (reference, port) config pair: None,
    a ``(bits, G, rp_ratio, vm)`` tuple, or a list of those per layer."""
    def one(cc, c):
        return None if c is None else cc(c[0], c[1], c[2], vm=c[3])

    if isinstance(comp, list):
        return (tuple(one(JCC, c) for c in comp),
                tuple(one(TCC, c) for c in comp))
    return one(JCC, comp), one(TCC, comp)


def _cfgs(comp, n_classes=7, **kw):
    jc, tc = _both(comp)
    return (JCfg(arch="sage", hidden=HIDDEN, n_classes=n_classes,
                 compression=jc, **kw),
            TCfg(arch="sage", hidden=HIDDEN, n_classes=n_classes,
                 compression=tc, **kw))


def _view(c):
    return None if c is None else (c.bits, c.group_size, c.rp_ratio, c.vm,
                                   c.vm_dim)


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 3])
def test_flickr_like_and_in_adjacency_equal(seed):
    jg, tg = j_flickr_like(scale=SCALE, seed=seed), \
        t_flickr_like(scale=SCALE, seed=seed)
    assert (tg.n_nodes, tg.n_feats, tg.num_classes) == (535, 500, 7)
    for f in ("features", "labels", "edge_src", "edge_dst", "gcn_weight",
              "mean_weight", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    assert tg.name == jg.name and tg.num_classes == jg.num_classes
    for a, b in zip(t_in_adjacency(tg.edge_src, tg.edge_dst, tg.n_nodes),
                    j_in_adjacency(jg.edge_src, jg.edge_dst, jg.n_nodes)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ----------------------------------------------------------- GNNConfig
CONFIG_CASES = {
    "fp32": None,
    "broadcast": (2, 125, 8, False),
    "tuple": [(2, 125, 8, True), None, (4, 64, 0, False)],
    "all_none_tuple": [None, None, None],
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
@pytest.mark.parametrize("bits", [(8, 0, 1), (1, 2, 4), (None, 8, 8)])
def test_gnn_config_per_layer_views_equal(case, bits):
    jcfg, tcfg = _cfgs(CONFIG_CASES[case], dropout=0.5)
    assert tcfg.dropout == jcfg.dropout == 0.5
    assert tcfg.n_layers == jcfg.n_layers
    for jc, tc in ((jcfg, tcfg), (jcfg.with_layer_bits(bits),
                                  tcfg.with_layer_bits(bits))):
        assert [_view(c) for c in tc.layer_compression()] == \
            [_view(c) for c in jc.layer_compression()]
        tj = tc.with_impl("torch").layer_compression()
        assert [_view(c) for c in tj] == [_view(c) for c in
                                          tc.layer_compression()]
        assert all(c is None or c.impl == "torch" for c in tj)
    with pytest.raises(ValueError):
        tcfg.with_layer_bits((2, 2))
    with pytest.raises(ValueError):
        jcfg.with_layer_bits((2, 2))


def test_gnn_config_tuple_length_checked():
    jcfg, tcfg = _cfgs([(2, 125, 8, False), None])
    with pytest.raises(ValueError, match="2 entries"):
        tcfg.layer_compression()
    with pytest.raises(ValueError, match="2 entries"):
        jcfg.layer_compression()


# ------------------------------------------------------- quantize (whole)
@pytest.mark.parametrize("shape", [(7, 33), (1000,), (3, 4, 125)])
@pytest.mark.parametrize("bits,g,vm", [(2, 125, False), (2, 256, True),
                                       (8, 256, True), (4, 1000, False),
                                       (1, 64, False)])
def test_quantize_dequantize_bit_equal(shape, bits, g, vm):
    x = (np.random.default_rng(g + bits).normal(size=shape) * 1.9
         + 0.4).astype(np.float32)
    lv = optimize_levels(32, bits) if vm else None
    jc, jz, jr, jn = j_quant.quantize(jnp.asarray(x), bits, g, 77,
                                      None if lv is None else jnp.asarray(lv))
    tc, tz, tr, tn = t_quant.quantize(torch.from_numpy(x), bits, g, 77, lv)
    assert tn == jn
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jd = j_quant.dequantize(jc, jz, jr, bits, shape,
                            None if lv is None else jnp.asarray(lv))
    td = t_quant.dequantize(tc, tz, tr, bits, shape, lv)
    assert tuple(td.shape) == shape and td.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n,g,bits,vm", [
    (535, 125, 2, False), (535, 125, 2, True), (301, 250, 2, False),
    (67, 1000, 2, False), (41, 125, 1, False), (41, 125, 4, False),
    (41, 125, 8, False), (53, 256, 8, True), (29, 125, 8, True)])
def test_plain_quant_ragged_and_vm8_words_equal(n, g, bits, vm):
    """The configs the reference's kernels leave to its jnp path (ragged
    words, a 256-level table): the port's plain path writes the jnp path's
    words, zero and range (the CUDA kernels are held to this plain path on
    the card, ``tests/test_torch_cuda.py``)."""
    x = (np.random.default_rng(n).normal(size=(n, g)) * 2.3
         + 0.7).astype(np.float32)
    lv = optimize_levels(max(2, g // 8), bits) if vm else None
    jp, jz, jr = j_backend.quantize_blocks(jnp.asarray(x), bits, 42, lv,
                                           impl="jnp")
    for tp, tz, tr in (t_ops.quantize_packed(torch.from_numpy(x), bits, 42,
                                             lv, impl="torch"),
                       t_qk.quant_pack(torch.from_numpy(x), bits, 42, lv)):
        assert tp.shape == (n, -(-g * bits // 32))
        np.testing.assert_array_equal(tp.numpy(),
                                      np.asarray(jp).view(np.int32))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jd = j_backend.dequantize_blocks(jp, jz, jr, bits, g, lv, impl="jnp")
    td = t_qk.dequant_unpack(tp, tz, tr, bits, g, lv)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# ----------------------------------------------------------- byte ledger
REPORT_CASES = {
    "fp32": None,
    "int2_g125": (2, 125, 8, False),
    "int2_g1000": (2, 1000, 8, False),
    "int2_g125_vm": (2, 125, 8, True),
    "int8_g256_vm": (8, 256, 8, True),
    "mixed": [(1, 125, 8, False), (4, 250, 8, False), (8, 64, 0, False)],
    "none_entry": [(2, 125, 8, True), None, (2, 256, 8, False)],
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
@pytest.mark.parametrize("hidden", [(32, 32), (256, 256)])
def test_activation_memory_report_equal(case, hidden):
    jg, tg = _graphs()
    jc, tc = _both(REPORT_CASES[case])
    jcfg = JCfg(arch="sage", hidden=hidden, n_classes=7, compression=jc)
    tcfg = TCfg(arch="sage", hidden=hidden, n_classes=7, compression=tc)
    assert t_report(tg, tcfg) == j_report(jg, jcfg)


def test_activation_memory_report_quant_health():
    """``quant_health=`` attaches the probe's rows verbatim, beside the
    byte ledger, as the reference's report does (an empty list attaches
    nothing)."""
    from repro_torch.graph.analysis import variance_validation_report
    from repro_torch.graph.models import device_graph

    jg, tg = _graphs()
    jc, tc = _cfgs((2, 125, 8, False))
    jp = init_gnn_params(jax.random.PRNGKey(0), jc, jg.n_feats)
    model = params_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                               for p in jp], tc, device="cpu")
    rows = variance_validation_report(model, device_graph(tg, "sage", "cpu"),
                                      tc)
    got = t_report(tg, tc, quant_health=rows)
    assert got["quant_health"] is rows
    assert [r["layer"] for r in rows] == [0, 1, 2]
    want = j_report(jg, jc, quant_health=rows)
    assert got == want
    assert "quant_health" not in t_report(tg, tc, quant_health=[])


@pytest.mark.parametrize("kw", [
    {"plan": ExecutionPlan.from_legacy(n_parts=2, offload="device")},
    {"offload": "host"}])
def test_activation_memory_report_arena_section(kw):
    """The arena section at Table 1's flickr row equals the reference's,
    but for what is measured on a card."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs((2, 125, 8, False))
    got, want = t_report(tg, tcfg, **kw), j_report(jg, jcfg, **kw)
    measured = ("measured_live_bytes", "device_peak_bytes")
    for rep in (got, want):
        for key in measured:
            rep["arena"].pop(key)
    assert got == want


def test_train_gnn_offload_runs():
    """``offload="host"`` at the flickr row trains as ``offload=None`` does,
    bit for bit."""
    _, tg = _graphs()
    _, tcfg = _cfgs((2, 125, 8, False))
    off = t_train_gnn(tg, tcfg, n_epochs=1, offload="host", device="cpu")
    per = t_train_gnn(tg, tcfg, n_epochs=1, device="cpu")
    assert off["history"][0][1] == per["history"][0][1]
    assert all(torch.equal(a, b) for a, b in zip(off["model"].parameters(),
                                                 per["model"].parameters()))
    assert off["arena"]["planned_bytes"] == sum(per["stash_bytes"])


# ----------------------------------------------------------- 8-bit AdamW
@pytest.mark.parametrize("group", [256, 64])
@pytest.mark.parametrize("shapes", [((5, 3), (3,)), ((300, 7), (7,), (2,))])
def test_adamw_8bit_moments_bit_equal(group, shapes):
    rs = np.random.default_rng(len(shapes) + group)
    ps = [rs.normal(size=s).astype(np.float32) for s in shapes]
    kw = dict(lr=5e-3, weight_decay=0.01, state_bits=8, state_group=group)
    jcfg, tcfg = JAdam(**kw), TAdam(**kw)
    jp = [jnp.asarray(p) for p in ps]
    tp = [torch.from_numpy(p.copy()) for p in ps]
    js, ts = j_adamw_init(jp, jcfg), t_adamw_init(tp, tcfg)
    for step in range(3):
        gs = [rs.normal(size=s).astype(np.float32) for s in shapes]
        jp, js = j_adamw_update([jnp.asarray(g) for g in gs], js, jp, jcfg)
        t_adamw_update([torch.from_numpy(g) for g in gs], ts, tp, tcfg)
        for moment in ("m", "v"):
            for a, b in zip(ts[moment], js[moment]):
                np.testing.assert_array_equal(
                    a["p"].numpy(), np.asarray(b["p"]).view(np.int32))
                np.testing.assert_array_equal(a["z"].numpy(),
                                              np.asarray(b["z"]))
                np.testing.assert_array_equal(a["r"].numpy(),
                                              np.asarray(b["r"]))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert ts["step"] == int(js["step"]) == 3


def test_adamw_bf16_states_match_reference():
    rs = np.random.default_rng(9)
    ps = [rs.normal(size=(6, 4)).astype(np.float32)]
    kw = dict(lr=1e-2, state_dtype="bfloat16")
    jcfg, tcfg = JAdam(**kw), TAdam(**kw)
    jp, tp = [jnp.asarray(ps[0])], [torch.from_numpy(ps[0].copy())]
    js, ts = j_adamw_init(jp, jcfg), t_adamw_init(tp, tcfg)
    assert ts["m"][0].dtype == torch.bfloat16
    for _ in range(3):
        g = rs.normal(size=(6, 4)).astype(np.float32)
        jp, js = j_adamw_update([jnp.asarray(g)], js, jp, jcfg)
        t_adamw_update([torch.from_numpy(g)], ts, tp, tcfg)
    np.testing.assert_array_equal(
        ts["m"][0].float().numpy(),
        np.asarray(js["m"][0].astype(jnp.float32)))
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]), rtol=1e-6)


# --------------------------------------------------- Table-1 flickr rows
ROWS = {
    "fp32": (None, 0),
    "int2_exact_per_row": ((2, 125, 8, False), 0),
    "int2_block_gr8": ((2, 1000, 8, False), 0),
    "int2_vm": ((2, 125, 8, True), 0),
    "int2_vm_adamw8": ((2, 125, 8, True), 8),
    "mixed_none_entry": ([(4, 125, 8, False), None, (8, 250, 8, True)], 0),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_table1_flickr_rows_match_reference(row):
    """Three epochs of each Table-1 flickr row (and a mixed per-layer row
    with an uncompressed layer) from the same carried weights: losses
    within rtol 1e-3, the live stash equal to the byte ledger, the report
    equal to the reference's."""
    comp, state_bits = ROWS[row]
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(comp)
    opt = dict(lr=5e-3, weight_decay=0.0, state_bits=state_bits)
    jp = init_gnn_params(jax.random.PRNGKey(0), jcfg, jg.n_feats)
    model = params_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                               for p in jp], tcfg, device="cpu")
    rj = j_train_gnn(jg, jcfg, JAdam(**opt), n_epochs=3, seed=0,
                     verbose=True, eval_every=1, impl="jnp")
    rt = t_train_gnn(tg, tcfg, TAdam(**opt), n_epochs=3, seed=0,
                     params=model, device="cpu")
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-3)
    report = t_report(tg, rt["cfg"])
    assert report == j_report(jg, rj["cfg"])
    assert rt["stash_bytes"] == live_stash_bytes(tcfg, tg.n_feats,
                                                 tg.n_nodes)
    assert [n for n, r in zip(rt["stash_bytes"], report["per_layer"])
            if "compressed_bytes" in r] == [
        r["compressed_bytes"] for r in report["per_layer"]
        if "compressed_bytes" in r]
    assert rt["cfg"] == tcfg.with_impl("auto")


@pytest.mark.parametrize("scale", [0.05, 0.25])
def test_flickr_fp32_overshoot_matches_reference(scale):
    """The FP32 flickr row at the Table-1 widths (500 features, SAGE
    256-256, lr 5e-3), nodes cut to ``scale``: the reference's loss rises
    at epoch 1 before it falls, and the port's follows it within rtol 1e-3
    (so the overshoot the full-size row shows on the card is the model's,
    not the port's)."""
    jg, tg = j_flickr_like(scale=scale), t_flickr_like(scale=scale)
    jcfg = JCfg(arch="sage", hidden=(256, 256), n_classes=7)
    tcfg = TCfg(arch="sage", hidden=(256, 256), n_classes=7)
    jp = init_gnn_params(jax.random.PRNGKey(0), jcfg, jg.n_feats)
    model = params_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                               for p in jp], tcfg, device="cpu")
    opt = dict(lr=5e-3, weight_decay=0.0)
    rj = j_train_gnn(jg, jcfg, JAdam(**opt), n_epochs=3, seed=0,
                     verbose=True, eval_every=1, impl="jnp")
    rt = t_train_gnn(tg, tcfg, TAdam(**opt), n_epochs=3, seed=0,
                     params=model, device="cpu")
    lj, lt = [h[1] for h in rj["history"]], [h[1] for h in rt["history"]]
    print(f"flickr_like({scale}) {tg.n_nodes} nodes FP32 losses: reference "
          f"{lj}, port {lt}")
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert lj[1] > lj[0] and lt[1] > lt[0]
