"""The mini-batch partition engine on the CPU against the JAX reference:
the partitioners and padded batches, the seed and order scheme, the
streamed generators, padding that changes nothing, one padded-batch step,
``train_gnn_batched`` end to end (grad accumulation, halo, autoprec), the
batched byte ledger, and the plan's mapping and validation.

Setup: the reference's mini-batch test graph (700 nodes, 32 features, 5
classes), SAGE, G = 64, RP 8; the reference runs ``impl="jnp"`` and the
port starts from the reference's weights (``params_from_numpy``).
Tolerances: arrays, widths, budgets, byte counts and the n_parts = 1
identity exactly; losses and gradients rtol 1e-3 (as
tests/test_torch_gnn.py: another summation order can flip a rare SR code).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressor import CompressionConfig as JCC
from repro.engine import seeds as j_seeds
from repro.engine.compile import engine_loss
from repro.engine.forward import TENSOR_STASH, plan_gnn_stashes
from repro.graph import data as j_data
from repro.graph import sampling as j_sampling
from repro.graph.models import GNNConfig as JCfg
from repro.graph.models import init_gnn_params
from repro.graph.train import activation_memory_report as j_report
from repro.graph.train import train_gnn_batched as j_train_batched
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.engine import seeds as t_seeds
from repro_torch.engine.compile import masked_nll
from repro_torch.engine.forward import stash_gnn_forward
from repro_torch.engine.plan import (ExecutionPlan, KernelPolicy,
                                     PrecisionPolicy, SamplingPolicy,
                                     StashPolicy)
from repro_torch.graph import data as t_data
from repro_torch.graph import sampling as t_sampling
from repro_torch.graph.models import GNNConfig as TCfg
from repro_torch.graph.models import device_graph, params_from_numpy
from repro_torch.graph.train import activation_memory_report as t_report
from repro_torch.graph.train import train_gnn as t_train_gnn
from repro_torch.graph.train import train_gnn_batched as t_train_batched

GRAPH_ARGS = ("t", 700, 3500, 32, 5)
GRAPH_KW = dict(homophily=0.5, feature_noise=1.5, seed=1)
BATCH_FIELDS = ("features", "labels", "edge_src", "edge_dst", "gcn_weight",
                "mean_weight", "train_mask", "val_mask", "test_mask",
                "node_mask", "n_real_nodes", "n_real_edges")


@functools.lru_cache(maxsize=None)
def _graphs():
    return (j_data.synthetic_graph(*GRAPH_ARGS, **GRAPH_KW),
            t_data.synthetic_graph(*GRAPH_ARGS, **GRAPH_KW))


def _cfgs(comp=True, hidden=(32,), arch="sage"):
    jc = JCC(bits=2, group_size=64, rp_ratio=8) if comp else None
    tc = TCC(bits=2, group_size=64, rp_ratio=8) if comp else None
    return (JCfg(arch=arch, hidden=hidden, n_classes=5, compression=jc),
            TCfg(arch=arch, hidden=hidden, n_classes=5, compression=tc))


def _carried(jcfg, tcfg, in_dim=32, seed=0):
    jp = init_gnn_params(jax.random.PRNGKey(seed), jcfg, in_dim)
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return jp, params_from_numpy(npp, tcfg, device="cpu")


def _assert_batches_equal(tb, jb):
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        for f in BATCH_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                          np.asarray(getattr(j, f)), f)
        assert (t.n_nodes, t.n_edges) == (j.n_nodes, j.n_edges)


# ------------------------------------------------------- the partitioners
@pytest.mark.parametrize("n_parts", [4, 7])
def test_partitions_equal_reference(n_parts):
    jg, tg = _graphs()
    np.testing.assert_array_equal(
        t_sampling.random_partition(tg.n_nodes, n_parts, seed=3),
        j_sampling.random_partition(jg.n_nodes, n_parts, seed=3))
    np.testing.assert_array_equal(
        t_sampling.bfs_partition(tg.edge_src, tg.edge_dst, tg.n_nodes,
                                 n_parts, seed=3),
        j_sampling.bfs_partition(jg.edge_src, jg.edge_dst, jg.n_nodes,
                                 n_parts, seed=3))


@pytest.mark.parametrize("renormalize", [False, True])
@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("method", ["bfs", "random"])
def test_batches_equal_reference(method, halo, renormalize):
    jg, tg = _graphs()
    kw = dict(method=method, halo=halo, seed=2, renormalize=renormalize)
    tb = t_sampling.make_subgraph_batches(tg, 4, **kw)
    _assert_batches_equal(tb, j_sampling.make_subgraph_batches(jg, 4, **kw))
    # one bucket for every batch; padding is zero and in no mask
    assert len({(b.n_nodes, b.n_edges) for b in tb}) == 1
    for b in tb:
        nl, el = b.n_real_nodes, b.n_real_edges
        assert nl < b.n_nodes and el < b.n_edges
        assert not b.features[nl:].any() and not b.mean_weight[el:].any()
        assert not (b.edge_src[el:].any() or b.edge_dst[el:].any())
        assert not (b.train_mask[nl:].any() or b.node_mask[nl:].any())


def test_one_tight_batch_is_the_full_graph():
    jg, tg = _graphs()
    kw = dict(node_multiple=1, edge_multiple=1)
    (b,) = t_sampling.make_subgraph_batches(tg, 1, **kw)
    _assert_batches_equal([b], j_sampling.make_subgraph_batches(jg, 1, **kw))
    for f in ("features", "labels", "edge_src", "edge_dst", "mean_weight"):
        assert torch.equal(getattr(b, f), getattr(tg, f))
    assert b.node_mask.all()


def test_partition_arguments_rejected():
    _, tg = _graphs()
    with pytest.raises(ValueError, match="n_parts"):
        t_sampling.random_partition(5, 6)
    with pytest.raises(ValueError, match="method"):
        t_sampling.make_subgraph_batches(tg, 2, method="metis")


# ------------------------------------------------------ seeds and order
@pytest.mark.parametrize("args", [(0, 8, 0, 1, 0, 1), (3, 8, 5, 1, 0, 1),
                                  (2, 4, 1, 2, 1, 1), (7, 6, 2, 3, 1, 2),
                                  (2**26, 16, 3, 4, 2, 2)])
def test_batch_ordinals_and_seeds_equal_reference(args):
    got = t_seeds.batch_ordinals(*args)
    want = np.asarray(j_seeds.batch_ordinals(*args))
    np.testing.assert_array_equal(got, want)
    for o in got:
        assert t_seeds.sr_seed(int(o)) == int(j_seeds.sr_seed(int(o)))


@pytest.mark.parametrize("ordinal", [2**32 - 1, 2**32, 2**32 + 5,
                                     3 * 2**32 + 17, 2**40 + 1])
def test_sr_seed_wraps_as_uint32(ordinal):
    assert t_seeds.sr_seed(ordinal) == int(j_seeds.sr_seed(ordinal))


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_order_rng_permutations_equal_reference(seed):
    assert t_seeds.ORDER_SALT == j_seeds.ORDER_SALT
    t_rng, j_rng = t_seeds.order_rng(seed), j_seeds.order_rng(seed)
    for n in (8, 8, 5, 16):
        np.testing.assert_array_equal(t_rng.permutation(n),
                                      j_rng.permutation(n))


# ------------------------------------------------- streamed generators
GRAPH_FIELDS = ("features", "labels", "edge_src", "edge_dst", "gcn_weight",
                "mean_weight", "train_mask", "val_mask", "test_mask")


@pytest.mark.parametrize("make", [
    lambda m: m.papers100m_like(4e-5),
    lambda m: m.synthetic_graph_streamed("s", 600, 5000, 8, 4, homophily=0.3,
                                         seed=5, chunk_edges=777),
    lambda m: m.synthetic_graph_streamed("s", 300, 2000, 4, 3, seed=2)])
def test_streamed_graphs_equal_reference(make):
    tg, jg = make(t_data), make(j_data)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), f)
    assert tg.num_classes == jg.num_classes


def test_stream_edge_chunks_equal_reference():
    labels = np.random.default_rng(0).integers(0, 6, 900)
    kw = dict(labels=labels, homophily=0.4, seed=9, chunk_edges=1000)
    got = list(t_data.stream_edge_chunks(900, 4321, **kw))
    want = list(j_data.stream_edge_chunks(900, 4321, **kw))
    assert len(got) == len(want) == 5
    for (ts, td), (js, jd) in zip(got, want):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(td, jd)
    with pytest.raises(ValueError, match="labels"):
        next(t_data.stream_edge_chunks(10, 10, homophily=0.5))


# ------------------------------------------------------ inert padding
def _padded_batch():
    _, tg = _graphs()
    b = t_sampling.make_subgraph_batches(tg, 2, method="bfs", seed=0)[0]
    assert b.n_real_nodes < b.n_nodes       # the bucket really pads
    dirty = dataclasses.replace(b, features=b.features.clone())
    dirty.features[b.n_real_nodes:] = 1e3
    return b, dirty


def _stash(logits) -> list[torch.Tensor]:
    """Each layer's stashed tensor (packed words, or the raw input)."""
    return [(e["ct"].packed if "ct" in e else e["raw"]).clone()
            for e in logits.grad_fn.stash]


def _step(model, dg, cfg, seed=3):
    logits = stash_gnn_forward(model, dg, cfg, seed)
    loss = masked_nll(logits, dg.labels, dg.train_mask)
    stash = _stash(logits)
    return logits, loss, torch.autograd.grad(loss, model.flat_params()), stash


@pytest.mark.parametrize("arch", ["sage", "gcn"])
@pytest.mark.parametrize("comp", [False, True])
def test_padding_changes_no_bit(arch, comp):
    """Garbage in the pad rows leaves the loss, every gradient and every
    stashed tensor as they were (the forward pins pad rows to zero before
    the stash sees them), and the logits' pad rows are exactly zero.
    Without the node mask the stash does change: the test has teeth."""
    jcfg, tcfg = _cfgs(comp, arch=arch)
    _, model = _carried(jcfg, tcfg)
    b, dirty = _padded_batch()
    dirty_g = device_graph(dirty, arch, "cpu")
    logits, l0, g0, s0 = _step(model, device_graph(b, arch, "cpu"), tcfg)
    _, l1, g1, s1 = _step(model, dirty_g, tcfg)
    assert l0.item() == l1.item()
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))
    assert all(torch.equal(a, c) for a, c in zip(s0, s1))
    assert not logits.detach()[b.n_real_nodes:].any()
    unmasked = dataclasses.replace(dirty_g, node_mask=None)
    s2 = _stash(stash_gnn_forward(model, unmasked, tcfg, 3))
    assert not all(torch.equal(a, c) for a, c in zip(s0, s2))


@pytest.mark.parametrize("max_edges", [64, 1000, 1 << 19])
def test_pad_edges_stay_in_row_zero_runs(max_edges):
    """A padded batch's pad edges (node 0 to node 0, weight 0) sort into
    CSR row 0 in both directions; cutting the rows into runs of at most
    ``max_edges`` edges (a heavier row alone) changes no bit of the
    aggregation, and row 0 sums its real edges only (within 1e-6 of the
    CSR without pad edges: row 0's longer sum may be added in another
    order)."""
    from repro_torch.graph import models as t_models

    _, tg = _graphs()
    b = t_sampling.make_subgraph_batches(tg, 3, halo=1, seed=0)[0]
    s, d = b.edge_src.numpy(), b.edge_dst.numpy()
    w = b.mean_weight.numpy()
    h = torch.from_numpy(np.random.default_rng(4).normal(
        size=(b.n_nodes, 8)).astype(np.float32))
    el = b.n_real_edges
    for rows, cols in ((d, s), (s, d)):
        one = t_models._csr(rows, cols, w, b.n_nodes, "cpu", 1 << 30)
        cut = t_models._csr(rows, cols, w, b.n_nodes, "cpu", max_edges)
        pad = b.n_edges - el
        assert int(one.offsets[1]) == int((rows[:el] == 0).sum()) + pad
        assert all(e1 - e0 <= max_edges or r1 - r0 == 1
                   for r0, r1, e0, e1, _ in cut.parts)
        got = t_models.spmm(h, cut)
        assert torch.equal(got, t_models.spmm(h, one))
        real = t_models._csr(rows[:el], cols[:el], w[:el], b.n_nodes, "cpu",
                             max_edges)
        np.testing.assert_allclose(got.numpy(), t_models.spmm(h, real).numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["sage", "gcn"])
def test_primal_forward_pins_pad_rows(arch):
    jcfg, tcfg = _cfgs(False, arch=arch)
    _, model = _carried(jcfg, tcfg)
    b, dirty = _padded_batch()
    with torch.no_grad():
        out = model(device_graph(dirty, arch, "cpu"))
        ref = model(device_graph(b, arch, "cpu"))
    assert torch.equal(out, ref) and not out[b.n_real_nodes:].any()


@pytest.mark.parametrize("arch", ["sage", "gcn"])
def test_padded_batch_step_matches_reference(arch):
    """One padded batch (halo 1, so halo rows aggregate) through the port's
    stash forward and manual backward against the reference's
    ``engine_loss(..., node_mask)``."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(hidden=(32, 32), arch=arch)
    jp, model = _carried(jcfg, tcfg)
    jb = j_sampling.make_subgraph_batches(jg, 3, halo=1, seed=0)[1]
    tb = t_sampling.make_subgraph_batches(tg, 3, halo=1, seed=0)[1]
    sr = j_seeds.sr_seed(5)
    splan = plan_gnn_stashes(jcfg, jg.n_feats, jb.n_nodes)
    loss_j, grads_j = jax.value_and_grad(engine_loss)(
        jp, jb.graph_tuple(), jb.labels, jb.train_mask, jcfg, sr,
        jb.node_mask, splan, TENSOR_STASH)
    _, loss_t, grads_t, _ = _step(model, device_graph(tb, arch, "cpu"),
                                  tcfg, int(sr))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = [np.asarray(g[k]) for g in grads_j for k in ("w", "b")]
    for got, w in zip(grads_t, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())


# ----------------------------------------------------- the engine end to end
@pytest.mark.parametrize("arch", ["sage", "gcn"])
def test_nparts1_tight_is_train_gnn_bit_for_bit(arch):
    _, tg = _graphs()
    jcfg, tcfg = _cfgs(hidden=(32, 32), arch=arch)
    _, model = _carried(jcfg, tcfg)
    full = t_train_gnn(tg, tcfg, n_epochs=4, params=model, device="cpu")
    one = t_train_batched(tg, tcfg, 1, n_epochs=4, params=model,
                          device="cpu", node_multiple=1, edge_multiple=1)
    assert [h[1] for h in one["history"]] == [h[1] for h in full["history"]]
    assert all(torch.equal(p, q) for p, q in
               zip(full["model"].parameters(), one["model"].parameters()))
    assert (one["test_acc"], one["stash_bytes"]) == (full["test_acc"],
                                                      full["stash_bytes"])
    assert (one["updates_per_epoch"], one["batch_nodes"]) == (1, tg.n_nodes)


@pytest.mark.parametrize("kw", [dict(n_parts=4, grad_accum=2, halo=1),
                                dict(n_parts=3, method="random"),
                                dict(n_parts=4, shuffle=False,
                                     renormalize=True)])
def test_train_gnn_batched_matches_reference(kw):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs()
    _, model = _carried(jcfg, tcfg)
    kw = dict(kw)
    n_parts = kw.pop("n_parts")
    rj = j_train_batched(jg, jcfg, n_parts, n_epochs=3, seed=0, impl="jnp",
                         verbose=True, eval_every=1, **kw)
    rt = t_train_batched(tg, tcfg, n_parts, n_epochs=3, seed=0, params=model,
                         device="cpu", **kw)
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-3)
    for k in ("n_parts", "updates_per_epoch", "batch_nodes", "batch_edges"):
        assert rt[k] == rj[k], k
    assert abs(rt["val_acc"] - rj["val_acc"]) < 0.02
    # the live stash of the last forward is one padded batch's ledger
    rep = t_report(tg, tcfg, n_parts, batch_nodes=rt["batch_nodes"])
    assert rt["stash_bytes"] == [r["compressed_bytes"]
                                 for r in rep["batched"]["per_layer"]]


def test_batched_autoprec_matches_reference():
    """Calibrated on one padded batch: the same per-batch budget and
    widths, re-solved at epoch 2, and losses within rtol 1e-3."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(hidden=(32, 32))
    _, model = _carried(jcfg, tcfg)
    kw = dict(n_epochs=4, seed=0, bit_budget=2.0, autoprec_refresh=2)
    rj = j_train_batched(jg, jcfg, 4, impl="jnp", verbose=True, eval_every=1,
                         **kw)
    rt = t_train_batched(tg, tcfg, 4, params=model, device="cpu", **kw)
    assert rt["bits_per_layer"] == list(rj["bits_per_layer"])
    assert rt["bit_budget_bytes"] == rj["bit_budget_bytes"]
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-3)


def test_grad_accum_must_divide_n_parts():
    _, tg = _graphs()
    _, tcfg = _cfgs(False)
    with pytest.raises(ValueError, match="multiple"):
        t_train_batched(tg, tcfg, 3, n_epochs=1, grad_accum=2, device="cpu")


# ------------------------------------------------------- the byte ledger
@pytest.mark.parametrize("comp", [True, False])
@pytest.mark.parametrize("kw", [dict(n_parts=4), dict(n_parts=4,
                                                      batch_nodes=256),
                                dict(n_parts=3, node_multiple=128),
                                dict(n_parts=1)])
def test_batched_memory_report_equal(kw, comp):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(comp, hidden=(64, 64))
    assert t_report(tg, tcfg, **kw) == j_report(jg, jcfg, **kw)


def test_batched_memory_report_reads_the_plan():
    from repro.engine.plan import ExecutionPlan as JPlan

    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(hidden=(64, 64))
    kw = dict(n_parts=5, node_multiple=32, halo=1)
    got = t_report(tg, tcfg, plan=ExecutionPlan.from_legacy(**kw))
    assert got == j_report(jg, jcfg, plan=JPlan.from_legacy(**kw))
    assert got["batched"]["n_parts"] == 5


# --------------------------------------------------- the plan's contract
def test_plan_from_legacy_mapping():
    p = ExecutionPlan.from_legacy()
    assert p.sampling.kind == "full" and p.stash.kind == "tensor"
    assert p.precision.kind == "fixed" and p.kernel.impl is None
    assert p.offload is None
    p = ExecutionPlan.from_legacy(n_parts=4, offload="host", impl="torch",
                                  bit_budget=1.5, autoprec_refresh=3,
                                  halo=1, grad_accum=2, shuffle=False)
    assert p.sampling == SamplingPolicy(kind="partition", n_parts=4, halo=1,
                                        grad_accum=2, shuffle=False)
    assert p.stash == StashPolicy(kind="arena", placement="host")
    assert p.offload == "host"
    assert p.precision == PrecisionPolicy(kind="autoprec", bit_budget=1.5,
                                          refresh=3)
    assert p.kernel == KernelPolicy(impl="torch")
    assert hash(p)
    assert "partition x4 (bfs, halo=1)" in p.describe()


@pytest.mark.parametrize("make,match", [
    (lambda: StashPolicy(kind="arena", placement="hsot"), "offload"),
    (lambda: StashPolicy(kind="tensor", placement="host"), "tensor"),
    (lambda: PrecisionPolicy(kind="autoprec"), "bit_budget"),
    (lambda: PrecisionPolicy(bit_budget=2.0), "bit_budget"),
    (lambda: PrecisionPolicy(calibration="obs"), "calibration"),
    (lambda: KernelPolicy(impl="pallas"), "impl"),
    (lambda: KernelPolicy(fused="yes"), "fused"),
    (lambda: SamplingPolicy(kind="full", n_parts=2), "n_parts"),
    (lambda: SamplingPolicy(kind="partition", grad_accum=0), "grad_accum"),
    (lambda: SamplingPolicy(kind="cluster"), "kind")])
def test_plan_validation(make, match):
    with pytest.raises(ValueError, match=match):
        make()


@pytest.mark.parametrize("call,item", [
    (lambda g, c: ExecutionPlan(obs=object()), "A.10")])
def test_unported_parts_raise(call, item):
    _, tg = _graphs()
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match=item):
        call(tg, tcfg)


def test_train_gnn_batched_offload_host_runs():
    """``offload="host"`` trains the batches as the per-tensor stash does,
    bit for bit, with the arena planned over one padded batch."""
    _, tg = _graphs()
    _, tcfg = _cfgs()
    kw = dict(n_epochs=1, shuffle=False, device="cpu")
    off = t_train_batched(tg, tcfg, 2, offload="host", **kw)
    per = t_train_batched(tg, tcfg, 2, **kw)
    assert off["history"][0][1] == per["history"][0][1]
    assert all(torch.equal(a, b) for a, b in zip(off["model"].parameters(),
                                                 per["model"].parameters()))
    assert off["arena"]["planned_bytes"] == sum(per["stash_bytes"])


def test_report_batched_arena_section():
    """``n_parts=2, offload="device"``: the arena is planned over one padded
    batch, as the reference plans it."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs()
    got = t_report(tg, tcfg, n_parts=2, offload="device")
    want = j_report(jg, jcfg, n_parts=2, offload="device")
    for rep in (got, want):
        for key in ("measured_live_bytes", "device_peak_bytes"):
            rep["arena"].pop(key)
    assert got == want
    assert got["arena"]["stash_nodes"] == got["batched"]["batch_nodes"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_train_gnn_batched_needs_a_card_unless_cpu():
    _, tg = _graphs()
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train_batched(tg, tcfg, 2, n_epochs=1)
