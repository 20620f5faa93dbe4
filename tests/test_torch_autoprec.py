"""Autoprec on the port, on the CPU, against the JAX reference: the copied
allocator on the same statistics, the probe seeds, the per-layer
statistics pass, the Table-2 instrumentation, and ``train_gnn(bit_budget=,
autoprec_refresh=)`` end to end (the budget, the widths, the losses).

Setup: the reference's autoprec test graph (768 nodes, 64 features, 6
classes), hidden (32, 32), G = 64, RP 8.  Tolerances: widths, budgets and
byte counts exactly; statistics and Table-2 numbers rtol 1e-5 (float32
sums in another order; for Eq. 19 the ratio of the error sums); losses
rtol 1e-3 (as tests/test_torch_gnn.py).
"""
import functools

import jax
import numpy as np
import pytest

from repro.core import autoprec as j_ap
from repro.core.compressor import CompressionConfig as JCC
from repro.engine import seeds as j_seeds
from repro.graph import analysis as j_analysis
from repro.graph.data import synthetic_graph as j_synthetic_graph
from repro.graph.models import GNNConfig as JCfg
from repro.graph.models import graph_tuple, init_gnn_params
from repro.graph.train import activation_memory_report as j_report
from repro.graph.train import train_gnn as j_train_gnn
from repro_torch.core import autoprec as t_ap
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.engine import seeds as t_seeds
from repro_torch.engine.compile import CompiledFull
from repro_torch.engine.precision import AutoprecController
from repro_torch.graph import analysis as t_analysis
from repro_torch.graph.data import synthetic_graph as t_synthetic_graph
from repro_torch.graph.models import GNNConfig as TCfg
from repro_torch.graph.models import device_graph, params_from_numpy
from repro_torch.graph.train import activation_memory_report as t_report
from repro_torch.graph.train import train_gnn as t_train_gnn
from repro_torch.optim import AdamWConfig as TAdam
from torch_threads import one_thread  # noqa: F401

GRAPH_ARGS = ("autoprec", 768, 4000, 64, 6)
GRAPH_KW = dict(homophily=0.6, feature_noise=1.0, seed=2)


@functools.lru_cache(maxsize=None)
def _graphs():
    return (j_synthetic_graph(*GRAPH_ARGS, **GRAPH_KW),
            t_synthetic_graph(*GRAPH_ARGS, **GRAPH_KW))


def _cfgs(arch="sage", vm=False, per_layer=None, group=64, rp=8):
    """(reference, port) configs; ``per_layer`` lists the compressed layers
    as True/False (False: None in the tuple)."""
    jc, tc = JCC(2, group, rp, vm=vm), TCC(2, group, rp, vm=vm)
    if per_layer is not None:
        jc = tuple(jc if on else None for on in per_layer)
        tc = tuple(tc if on else None for on in per_layer)
    return (JCfg(arch=arch, hidden=(32, 32), n_classes=6, compression=jc),
            TCfg(arch=arch, hidden=(32, 32), n_classes=6, compression=tc))


def _carried(jcfg, tcfg, seed=0):
    jg, _ = _graphs()
    jp = init_gnn_params(jax.random.PRNGKey(seed), jcfg, jg.n_feats)
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return jp, params_from_numpy(npp, tcfg, device="cpu")


# ------------------------------------------------------------- allocator
def _stats(mod, grad_sens):
    sens = (5.0, 2e3, 1e-3) if grad_sens else (None, None, None)
    return [mod.LayerStats((256, 32), 128, 900.0, sens[0]),
            mod.LayerStats((256, 16), 64, 25.0, sens[1]),
            None,
            mod.LayerStats((256, 16), 64, 1e-4, sens[2])]


def _templates(cc, vm):
    return [cc(2, 64, 8, vm=vm), cc(2, 64, 8, vm=vm), None,
            cc(2, 256, 0, vm=vm)]


@pytest.mark.parametrize("avg", [1.0, 1.5, 2.0, 3.0, 8.0])
@pytest.mark.parametrize("vm", [False, True])
@pytest.mark.parametrize("grad_sens", [False, True])
def test_autoprec_functions_equal_on_the_same_stats(avg, vm, grad_sens):
    js, ts = _stats(j_ap, grad_sens), _stats(t_ap, grad_sens)
    jt, tt = _templates(JCC, vm), _templates(TCC, vm)
    assert t_ap.BIT_CHOICES == j_ap.BIT_CHOICES
    for a, b, c, d in zip(ts, js, tt, jt):
        if a is None or c is None:
            continue
        assert a.n_elements == b.n_elements
        assert t_ap.normalized_sr_variance(c) == \
            j_ap.normalized_sr_variance(d)
        assert t_ap.expected_layer_variance(a, c) == \
            j_ap.expected_layer_variance(b, d)
        assert t_ap.layer_stash_bytes(a, c) == j_ap.layer_stash_bytes(b, d)
    budget = t_ap.budget_bytes_for(ts, tt, avg)
    assert budget == j_ap.budget_bytes_for(js, jt, avg)
    bits = t_ap.allocate_bits(ts, tt, budget)
    assert bits == j_ap.allocate_bits(js, jt, budget)
    tcfgs = [None if c is None else c.__class__(b, c.group_size, c.rp_ratio,
                                                vm=c.vm)
             for c, b in zip(tt, bits)]
    jcfgs = [None if c is None else c.__class__(b, c.group_size, c.rp_ratio,
                                                vm=c.vm)
             for c, b in zip(jt, bits)]
    assert t_ap.total_stash_bytes(ts, tcfgs) == \
        j_ap.total_stash_bytes(js, jcfgs)
    assert t_ap.total_expected_variance(ts, tcfgs) == \
        j_ap.total_expected_variance(js, jcfgs)


@pytest.mark.parametrize("seed", [0, 1, 2, 12345, 2**31 + 5, 2**40 + 3])
def test_probe_seeds_equal(seed):
    assert t_seeds.probe_seeds(seed) == tuple(
        int(s) for s in j_seeds.probe_seeds(seed))


# --------------------------------------------------------- stats passes
STATS_CASES = {
    "sage_rp8": dict(arch="sage"),
    "gcn_rp8": dict(arch="gcn"),
    "sage_none_entry": dict(arch="sage", per_layer=(True, False, True)),
    "sage_rp0_g256": dict(arch="sage", rp=0, group=256),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
@pytest.mark.parametrize("seed", [0, 3])
def test_collect_layer_stats_equal(case, seed):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(**STATS_CASES[case])
    jp, model = _carried(jcfg, tcfg, seed)
    want = j_analysis.collect_layer_stats(jp, graph_tuple(jg), jcfg,
                                          seed=seed)
    got = t_analysis.collect_layer_stats(
        model, device_graph(tg, tcfg.arch, "cpu"), tcfg, seed=seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert (a.shape, a.n_blocks) == (b.shape, b.n_blocks)
        np.testing.assert_allclose(a.rng_sq_mean, b.rng_sq_mean, rtol=1e-5)


@pytest.mark.parametrize("arch", ["sage", "gcn"])
def test_projected_activations_and_table2_row(arch):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    jp, model = _carried(jcfg, tcfg)
    want = j_analysis.collect_projected_activations(jp, graph_tuple(jg),
                                                    jcfg, seed=5)
    got = t_analysis.collect_projected_activations(
        model, device_graph(tg, arch, "cpu"), tcfg, seed=5)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for hbar in want:
        t_row, j_row = t_analysis.table2_row(hbar), j_analysis.table2_row(hbar)
        assert t_row["R"] == j_row["R"]
        for key in ("js_uniform", "js_clipnorm"):
            np.testing.assert_allclose(t_row[key], j_row[key], rtol=1e-5)
        # Eq. 19's ratio of the two float32 error sums; the percentage is
        # 100 (1 - ratio), near 0 here, where a relative bound says nothing
        np.testing.assert_allclose(1 - t_row["var_reduction_pct"] / 100,
                                   1 - j_row["var_reduction_pct"] / 100,
                                   rtol=1e-5)


# ------------------------------------------------------------- training
TRAIN_CASES = {
    "sage_budget2": (dict(arch="sage"), 2.0, 2),
    "sage_budget3": (dict(arch="sage"), 3.0, 2),
    "gcn_budget2p5": (dict(arch="gcn"), 2.5, 0),
    "sage_vm_budget2": (dict(arch="sage", vm=True), 2.0, 2),
    "sage_none_entry": (dict(arch="sage", per_layer=(True, False, True)),
                        2.0, 2),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_gnn_bit_budget_matches_reference(case):
    """The reference's autoprec recipe, four epochs with a re-solve at
    epoch 2: the same budget, the same widths, losses within rtol 1e-3, the
    allocation within the budget and the live stash equal to the ledger."""
    kw, budget, refresh = TRAIN_CASES[case]
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(**kw)
    _, model = _carried(jcfg, tcfg)
    rj = j_train_gnn(jg, jcfg, n_epochs=4, seed=0, verbose=True,
                     eval_every=1, impl="jnp", bit_budget=budget,
                     autoprec_refresh=refresh)
    rt = t_train_gnn(tg, tcfg, n_epochs=4, seed=0, params=model,
                     bit_budget=budget, autoprec_refresh=refresh,
                     device="cpu")
    assert rt["bits_per_layer"] == rj["bits_per_layer"]
    assert rt["bit_budget_bytes"] == rj["bit_budget_bytes"]
    assert all(b in t_ap.BIT_CHOICES or (b == 0 and c is None)
               for b, c in zip(rt["bits_per_layer"],
                               tcfg.layer_compression()))
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-3)
    per = rt["cfg"].layer_compression()
    stats = t_analysis.collect_layer_stats(
        rt["model"], device_graph(tg, tcfg.arch, "cpu"), tcfg)
    assert t_ap.total_stash_bytes(stats, per) <= rt["bit_budget_bytes"]
    report = t_report(tg, rt["cfg"])
    assert report == j_report(jg, rj["cfg"])
    assert report["bits_per_layer"] == [
        None if c is None else c.bits for c in per]
    compressed = [r["compressed_bytes"] for r in report["per_layer"]
                  if "compressed_bytes" in r]
    assert [n for n, c in zip(rt["stash_bytes"], per) if c is not None] \
        == compressed
    assert rt["stash_bytes"] == t_analysis.live_stash_bytes(
        rt["cfg"], tg.n_feats, tg.n_nodes)


@pytest.mark.parametrize("arch", ["sage", "gcn"])
def test_pinned_8bit_vm_trains_like_reference(arch):
    """Every layer at 8 bits with a 256-level VM table (what an autoprec
    allocation may pin): two epochs within rtol 1e-3 of the reference's jnp
    path, the stash at the 8-bit ledger."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch, vm=True)
    jcfg, tcfg = jcfg.with_layer_bits((8, 8, 8)), tcfg.with_layer_bits(
        (8, 8, 8))
    _, model = _carried(jcfg, tcfg)
    rj = j_train_gnn(jg, jcfg, n_epochs=2, seed=0, verbose=True,
                     eval_every=1, impl="jnp")
    rt = t_train_gnn(tg, tcfg, n_epochs=2, seed=0, params=model,
                     device="cpu")
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-3)
    assert rt["stash_bytes"] == [
        r["compressed_bytes"] for r in t_report(tg, tcfg)["per_layer"]]


# ----------------------------------------------------------- lifecycle
def test_controller_rules():
    _, tg = _graphs()
    _, tcfg = _cfgs()
    dg = device_graph(tg, "sage", "cpu")
    with pytest.raises(ValueError, match="calibration"):
        AutoprecController(dg, tcfg, 2.0, 2, 0, calibration="bogus")
    with pytest.raises(ValueError, match="compression"):
        AutoprecController(dg, TCfg(hidden=(32, 32), n_classes=6), 2.0, 2, 0)
    ctrl = AutoprecController(dg, tcfg, 2.0, 3, 0)
    assert [ctrl.due(e) for e in range(7)] == [False, False, False, True,
                                               False, False, True]
    assert not AutoprecController(dg, tcfg, 2.0, 0, 0).due(3)
    _, model = _carried(*_cfgs())
    cfg, changed = ctrl.allocate(model)
    assert changed and ctrl.extras()["bits_per_layer"] == [
        c.bits for c in cfg.layer_compression()]
    budget = ctrl.budget_bytes
    cfg2, changed2 = ctrl.allocate(model)
    assert ctrl.budget_bytes == budget       # frozen on the first allocate
    assert cfg2 == cfg and not changed2


@pytest.mark.parametrize("arch", ["sage", "gcn"])
def test_obs_calibration_allocates_as_reference(arch):
    """``calibration="obs"`` prices each layer from the quant-health probe's
    measured variance: the same widths and budget as the reference's
    controller on the same weights, and the widths its sensitivities give
    through the copied allocator."""
    from repro.engine.precision import AutoprecController as JController
    from repro_torch.obs.quantstats import (measure_quant_health,
                                            measured_sensitivity)

    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    jp, model = _carried(jcfg, tcfg)
    dg = device_graph(tg, arch, "cpu")
    ctrl = AutoprecController(dg, tcfg, 2.0, 2, 0, calibration="obs")
    cfg, changed = ctrl.allocate(model)
    jctrl = JController(graph_tuple(jg), jg.labels,
                        jg.train_mask.astype(np.float32), jcfg, 2.0, 2, 0,
                        calibration="obs")
    jctrl.allocate(jp)
    assert changed and ctrl.bits == jctrl.bits
    assert ctrl.budget_bytes == jctrl.budget_bytes
    assert [c.bits for c in cfg.layer_compression()] == list(ctrl.bits)
    stats = t_analysis.collect_layer_stats(model, dg, tcfg)
    sens = measured_sensitivity(measure_quant_health(model, dg, tcfg),
                                tcfg.layer_compression())
    stats = [s.__class__(s.shape, s.n_blocks, s.rng_sq_mean, v)
             for s, v in zip(stats, sens)]
    assert t_ap.allocate_bits(stats, tcfg.layer_compression(),
                              ctrl.budget_bytes) == ctrl.bits


def test_recompile_keeps_model_state_and_graph():
    _, tg = _graphs()
    _, tcfg = _cfgs()
    _, model = _carried(*_cfgs())
    step = CompiledFull(device_graph(tg, "sage", "cpu"), tcfg, model,
                        TAdam(lr=5e-3))
    step.step(0)
    state, graph = step.state, step.graph
    new = tcfg.with_layer_bits((8, 1, 4))
    assert step.recompile(new) is step
    assert step.cfg == new and step.state is state and step.graph is graph
    assert step.model is model and step.state["step"] == 1
    step.step(1)
    assert step.state["step"] == 2
