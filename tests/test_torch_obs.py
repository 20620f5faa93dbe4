"""The port's observability package (``repro_torch.obs``) against the
reference's ``repro.obs``, case for case with ``tests/test_obs.py`` at its
size (``cora_like(scale=0.2)``, SAGE (32,), 3 epochs), on the CPU.

obs-on training is bit-identical to obs-off under the full, partition and
mesh plans; spans nest and export to the reference's schemas; the metrics
primitives, null registries and session restore behave as the reference's;
the quant-health probe agrees with its own conditional expectation and
with Eq. 10, and with the reference's probe on the same weights and graph:
counts equal, range moments within rtol 1e-5, and without RP the codes are
bit-equal, so ``sat_rate`` is equal and ``measured_var`` within rtol 1e-6;
with RP 8 (the projection's float32 sums run in another order)
``measured_var`` within rtol 1e-3 and ``sat_rate`` within atol 1e-3.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core.act_compress import CompressionConfig as JCC
from repro.graph import GNNConfig as JCfg
from repro.graph import cora_like as j_cora
from repro.graph.analysis import (
    variance_validation_report as j_variance_report)
from repro.graph.models import graph_tuple, init_gnn_params
from repro.obs.quantstats import health_rows as j_health_rows
from repro.obs.quantstats import measure_quant_health as j_measure
from repro.obs.quantstats import measured_sensitivity as j_sensitivity
from repro_torch.core import backend
from repro_torch.core import quant as quantmod
from repro_torch.core.compressor import RP_SEED_SALT
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.engine.plan import (ExecutionPlan, KernelPolicy, ObsPolicy,
                                     PrecisionPolicy, SamplingPolicy)
from repro_torch.engine.runner import run
from repro_torch.engine.seeds import layer_seed
from repro_torch.graph import GNNConfig as TCfg
from repro_torch.graph import cora_like as t_cora
from repro_torch.graph.analysis import variance_validation_report
from repro_torch.graph.models import device_graph, params_from_numpy
from repro_torch.obs.metrics import (NULL_COUNTER, NULL_HISTOGRAM, Counter,
                                     Gauge, Histogram, MetricsRegistry,
                                     get_metrics)
from repro_torch.obs.quantstats import (STAT_FIELDS, QuantHealthMonitor,
                                        health_rows, layer_health,
                                        measure_quant_health,
                                        measured_sensitivity)
from repro_torch.obs.session import NULL_SESSION, ObsSession
from repro_torch.obs.trace import Tracer, set_tracer, stopwatch
from repro_torch.offload.pager import FeaturePager
from repro_torch.parallel import run_ranks
from torch_threads import one_thread  # noqa: F401

COMP = dict(bits=2, group_size=64, rp_ratio=8)

#: The full-surface policy the bit-identity matrix runs under.
OBS = ObsPolicy(enabled=True, trace=True, metrics=True, quant_stats=True,
                quant_stats_every=2)

#: The probe's configurations held against the reference: RP 8 as the
#: tests of the reference run it, and without RP at 2 and 4 bits.  Every
#: layer's element count leaves a padded tail in the last block (G = 100
#: without RP, whose words are also ragged).  The reference's probe raises
#: on a VM level table (it hands the table's tuple to its quantizer), so
#: VM runs only in :func:`test_probe_is_the_compressor`.
PROBE_CASES = {
    "rp8": dict(bits=2, group_size=64, rp_ratio=8),
    "rp0": dict(bits=2, group_size=100, rp_ratio=0),
    "rp0-4bit": dict(bits=4, group_size=100, rp_ratio=0),
}
#: The port's own probe against its compressor, VM included.
OWN_CASES = {**PROBE_CASES,
             "rp8-vm": dict(bits=2, group_size=64, rp_ratio=8, vm=True),
             "rp0-vm": dict(bits=2, group_size=100, rp_ratio=0, vm=True)}


@pytest.fixture(scope="module")
def graphs():
    return j_cora(scale=0.2, seed=0), t_cora(scale=0.2, seed=0)


@pytest.fixture(scope="module")
def g(graphs):
    return graphs[1]


def _cfg(g, comp=None, hidden=(32,)):
    return TCfg(arch="sage", hidden=hidden, n_classes=g.num_classes,
                compression=TCC(**(comp or COMP)))


def _jcfg(g, comp=None, hidden=(32,)):
    return JCfg(arch="sage", hidden=hidden, n_classes=g.num_classes,
                compression=JCC(**(comp or COMP)))


def _both(graphs, comp=None):
    """The reference's weights (PRNGKey 0), its config, graph tuple and
    the port's model, config and device graph on them."""
    jg, tg = graphs
    jcfg, tcfg = _jcfg(jg, comp), _cfg(tg, comp)
    jp = init_gnn_params(jax.random.PRNGKey(0), jcfg, jg.n_feats)
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    model = params_from_numpy(npp, tcfg, device="cpu")
    return (jp, jcfg, graph_tuple(jg), model, tcfg,
            device_graph(tg, "sage", "cpu"))


def _plans(impl="torch"):
    kp = KernelPolicy(impl=impl)
    return {
        "full": ExecutionPlan(kernel=kp),
        "partition": ExecutionPlan(
            sampling=SamplingPolicy(kind="partition", n_parts=2), kernel=kp),
        "mesh": ExecutionPlan(
            sampling=SamplingPolicy(kind="mesh", n_parts=2, shuffle=False),
            kernel=kp),
    }


def _run(g, cfg, plan, n_epochs=3):
    return run(g, cfg, plan, n_epochs=n_epochs, seed=0, device="cpu")


def _losses(res):
    return [h[1] for h in res["history"]]


# ----------------------------------------------------------- bit-identity
@pytest.mark.parametrize("kind", ["full", "partition", "mesh"])
def test_obs_on_is_bit_identical(g, kind):
    """The hard gate: spans, metrics and the quant probe on a 2-epoch
    cadence move no bit of the trajectory: losses, parameters, the live
    stash and the accuracies."""
    cfg = _cfg(g)
    plan_off = _plans()[kind]
    plan_on = dataclasses.replace(plan_off, obs=OBS)
    r_off = _run(g, cfg, plan_off)
    r_on = _run(g, cfg, plan_on)
    assert _losses(r_off) == _losses(r_on)
    for p, q in zip(r_off["model"].parameters(), r_on["model"].parameters()):
        assert torch.equal(p, q)
    assert r_off["stash_bytes"] == r_on["stash_bytes"]
    assert r_off["test_acc"] == r_on["test_acc"]
    assert "obs" not in r_off
    obs = r_on["obs"]
    assert obs.enabled
    rows = obs.quant_rows()
    assert rows and all(r["epoch"] == 2 for r in rows)
    assert all(r["predicted_var"] > 0 and r["measured_var"] > 0
               for r in rows)


# ------------------------------------------------------------------ spans
def test_span_tree_well_formed(g):
    plan = dataclasses.replace(_plans()["full"], obs=OBS)
    r = _run(g, _cfg(g), plan)
    spans = r["obs"].tracer.spans
    names = [s.name for s in spans]
    assert names.count("epoch") == 3
    assert "plan/compile" in names and "train/epochs" in names
    assert names.count("obs/quant_probe") == 2  # epochs 0 and 2
    for s in spans:
        assert s.dur >= 0.0
        if s.parent == -1:
            assert s.depth == 0
            continue
        p = spans[s.parent]
        assert s.depth == p.depth + 1
        assert s.t0 >= p.t0
        assert s.t0 + s.dur <= p.t0 + p.dur + 1e-6
    root = names.index("train/epochs")
    assert all(spans[i].parent == root
               for i, n in enumerate(names) if n == "epoch")

    def under(i):
        return [j for j, s in enumerate(spans) if s.parent == i]

    # each epoch's step (two SAGE layers: the forward aggregates before each
    # product, the backward after layer 1's product only)
    for ep in (i for i, n in enumerate(names) if n == "epoch"):
        [st] = under(ep)
        assert names[st] == "step"
        parts = under(st)
        assert [names[j] for j in parts] == ["step/forward", "step/loss",
                                             "step/backward", "optim/adamw"]
        fwd, loss, bwd, _ = parts
        assert under(loss) == []
        assert [(names[j], spans[j].args) for j in under(fwd)] == [
            ("gnn/spmm", {}), ("gnn/linear", {"layer": 0, "dir": "fwd"}),
            ("gnn/spmm", {}), ("gnn/linear", {"layer": 1, "dir": "fwd"})]
        assert [(names[j], spans[j].args) for j in under(bwd)] == [
            ("gnn/linear", {"layer": 1, "dir": "bwd"}), ("gnn/spmm", {}),
            ("gnn/linear", {"layer": 0, "dir": "bwd"})]
    snap = r["obs"].registry.snapshot()
    assert snap["engine/forward_builds"] == 1
    assert "engine/recompiles" not in snap


def test_mesh_round_spans_and_halo_counter(g):
    plan = dataclasses.replace(_plans()["mesh"], obs=OBS)
    r = _run(g, _cfg(g), plan, n_epochs=2)
    obs = r["obs"]
    names = [s.name for s in obs.tracer.spans]
    rounds = r["updates_per_epoch"]
    assert names.count("mesh/round") == 2 * rounds
    assert names.count("pager/fetch") == 2 * rounds
    # every fetch span sits inside its round's span
    spans = obs.tracer.spans
    assert all(spans[s.parent].name == "mesh/round"
               for s in spans if s.name == "pager/fetch")
    snap = obs.registry.snapshot()
    assert snap["pager/fetches"] == 2 * rounds
    assert snap["halo/bytes"] == r["halo_bytes_sent"]
    assert snap["halo/bytes"] == r["halo_bytes_per_epoch"] * 2
    ov = snap["pager/overlap_frac"]
    assert ov["count"] == 2 * rounds
    assert 0.0 <= ov["window_mean"] <= 1.0


def test_two_rank_mesh_sessions():
    """Two ranks, each with its own session: obs-on is obs-off bit for
    bit, and each rank's ``halo/bytes`` is the bytes it sent, above 0."""
    off = run_ranks(ranks.train_plan, 2, (False,), timeout=60.0)
    on = run_ranks(ranks.train_plan, 2, (True,), timeout=60.0)
    for a, b in zip(off, on):
        assert a["losses"] == b["losses"]
        for p, q in zip(a["params"], b["params"]):
            np.testing.assert_array_equal(p, q)
        snap = b["snapshot"]
        assert snap["halo/bytes"] == b["halo_bytes_sent"] > 0
        assert snap["pager/fetches"] == 2 * b["updates_per_epoch"]
        assert b["rounds"] == 2 * b["updates_per_epoch"]
    assert "snapshot" not in off[0]
    assert (on[0]["halo_bytes_sent"] + on[1]["halo_bytes_sent"]
            == 2 * on[0]["halo_bytes_per_epoch"])


def test_trace_exports_are_schema_valid(g, tmp_path):
    plan = dataclasses.replace(_plans()["full"], obs=OBS)
    r = _run(g, _cfg(g), plan, n_epochs=2)
    paths = r["obs"].export(tmp_path / "trace")
    lines = (tmp_path / "trace.jsonl").read_text().strip().split("\n")
    events = [json.loads(ln) for ln in lines]
    assert len(events) == len(r["obs"].tracer.spans)
    for e in events:
        assert set(e) == {"name", "ts_s", "dur_s", "depth", "parent", "args"}
    chrome = json.loads((tmp_path / "trace.trace.json").read_text())
    assert set(chrome) == {"traceEvents", "displayTimeUnit"}
    for ev in chrome["traceEvents"]:
        assert ev["ph"] == "X" and ev["cat"] == "repro"
        assert isinstance(ev["ts"], float) and isinstance(ev["dur"], float)
        assert ev["ts"] >= 0.0 and ev["dur"] >= 0.0
    assert paths["chrome"].endswith(".trace.json")


def test_stopwatch_measures_without_tracer():
    prev = set_tracer(None)
    try:
        with stopwatch() as sw:
            sum(range(1000))
        assert sw.elapsed_s > 0.0
        t = Tracer()
        set_tracer(t)
        with stopwatch("work", k=1) as sw:
            sum(range(1000))
    finally:
        set_tracer(prev)
    assert [s.name for s in t.spans] == ["work"]
    assert t.spans[0].args == {"k": 1}
    assert abs(t.spans[0].dur - sw.elapsed_s) < 0.05


# ---------------------------------------------------------------- metrics
def test_metrics_primitives():
    c, ga, h = Counter(), Gauge(), Histogram(window=4)
    c.inc(), c.inc(5)
    assert c.value == 6
    ga.set(3.0), ga.max(2.0), ga.max(7.0)
    assert ga.value == 7.0
    for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
        h.observe(v)
    assert h.count == 6 and h.mean == 3.5
    assert h.window_size == 4
    assert h.window_mean == 4.5       # last four: 3, 4, 5, 6
    assert h.window_min == 3.0 and h.window_max == 6.0
    assert h.vmin == 1.0 and h.vmax == 6.0


def test_disabled_registry_hands_out_nulls():
    reg = MetricsRegistry(enabled=False)
    assert reg.counter("x") is NULL_COUNTER
    assert reg.histogram("y") is NULL_HISTOGRAM
    reg.counter("x").inc()
    assert reg.snapshot() == {}
    get_metrics().counter("anything").inc()


def test_session_activation_restores_previous_actives():
    sess = ObsSession(ObsPolicy(enabled=True))
    before = get_metrics()
    with sess.activate():
        assert get_metrics() is sess.registry
    assert get_metrics() is before
    assert NULL_SESSION.registry is None and NULL_SESSION.tracer is None
    assert ObsSession.from_policy(None) is NULL_SESSION
    assert ObsSession.from_policy(ObsPolicy()) is NULL_SESSION


# ----------------------------------------------------------- quant health
def test_to_blocks_pads_as_the_reference():
    """The probe's tail mask relies on ``backend.to_blocks`` replicating the
    last element into the padded tail, as ``quant.group_reshape`` does."""
    from repro.core import quant as j_quant

    x = np.random.default_rng(0).normal(size=(37, 10)).astype(np.float32)
    blocks, n = backend.to_blocks(torch.from_numpy(x), 64)
    jb, jn = j_quant.group_reshape(x, 64)
    assert n == int(jn) == 370
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jb))


def test_measured_variance_is_the_conditional_expectation():
    """The probe's sq_err is one SR draw; over ~4k elements it concentrates
    on the conditional expectation Σ frac·(1−frac)·(rng/B)² of the same
    blocks, and its saturation rate is the endpoint share of the codes."""
    comp = TCC(bits=2, group_size=64, rp_ratio=8)
    x = torch.randn((512, 64), generator=torch.Generator().manual_seed(3))
    stats = layer_health(x, comp, 0, 0)
    assert stats.shape == (len(STAT_FIELDS),)
    ls = layer_seed(0, 0)
    xs = backend.rp(x, ls ^ RP_SEED_SALT, 64 // comp.rp_ratio)
    blocks, n_valid = backend.to_blocks(xs, comp.group_size)
    assert n_valid == blocks.numel()
    codes, zero, rng = quantmod.quantize_grouped(blocks, comp.bits, ls)
    B = 2 ** comp.bits - 1
    z, r = zero[:, None], rng[:, None]
    t = torch.clamp((blocks - z) / r, 0.0, 1.0) * B
    frac = t - torch.floor(t)
    expected = float(torch.sum(frac * (1 - frac) * (r / B) ** 2))
    assert expected > 0.0
    np.testing.assert_allclose(float(stats[2]), expected, rtol=0.1)
    sat = float(torch.mean(((codes == 0) | (codes == B)).to(torch.float32)))
    np.testing.assert_allclose(float(stats[5]), sat, rtol=1e-6)


def test_measured_variance_agrees_with_eq10_on_synthetic_gaussian(graphs):
    """Through RP the activations are the regime the CN_[1/D] model (Eq.
    10) was derived for: measured and predicted variance within 2x."""
    _, _, _, model, cfg, dg = _both(graphs)
    measured = measure_quant_health(model, dg, cfg, seed=0)
    rows = health_rows(measured, cfg.layer_compression())
    assert len(rows) == cfg.n_layers
    for r in rows:
        assert 0.4 < r["ratio"] < 2.5, r
    sens = measured_sensitivity(measured, cfg.layer_compression())
    assert all(s is not None and s > 0 for s in sens)


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_equal_to_reference(graphs, case):
    """The port's probe on the reference's weights and graph against the
    reference's ``measure_quant_health``, ``health_rows`` and
    ``measured_sensitivity`` (bands in the module docstring)."""
    comp = PROBE_CASES[case]
    jp, jcfg, gt, model, tcfg, dg = _both(graphs, comp)
    got = measure_quant_health(model, dg, tcfg, seed=0)
    want = j_measure(jp, gt, jcfg, seed=0)
    rp = comp["rp_ratio"] > 1
    var_rtol = 1e-3 if rp else 1e-6
    for a, b in zip(got, want):
        assert a["layer"] == b["layer"]
        assert a["n_elements"] == b["n_elements"]
        assert a["n_blocks"] == b["n_blocks"]
        assert a["n_elements"] % comp["group_size"]  # a padded tail
        np.testing.assert_allclose(a["rng_mean"], b["rng_mean"], rtol=1e-5)
        np.testing.assert_allclose(a["rng_sq_mean"], b["rng_sq_mean"],
                                   rtol=1e-5)
        np.testing.assert_allclose(a["measured_var"], b["measured_var"],
                                   rtol=var_rtol)
        if rp:
            np.testing.assert_allclose(a["sat_rate"], b["sat_rate"],
                                       atol=1e-3)
        else:
            assert a["sat_rate"] == b["sat_rate"]
    rows = health_rows(got, tcfg.layer_compression())
    jrows = j_health_rows(want, jcfg.layer_compression())
    assert len(rows) == len(jrows) == tcfg.n_layers
    for a, b in zip(rows, jrows):
        assert a["bits"] == b["bits"]
        np.testing.assert_allclose(a["predicted_var"], b["predicted_var"],
                                   rtol=1e-5)
        np.testing.assert_allclose(a["ratio"], b["ratio"], rtol=var_rtol)
    np.testing.assert_allclose(
        measured_sensitivity(got, tcfg.layer_compression()),
        j_sensitivity(want, jcfg.layer_compression()), rtol=var_rtol)
    report = variance_validation_report(model, dg, tcfg, seed=0)
    jreport = j_variance_report(jp, gt, jcfg, seed=0)
    assert [r["layer"] for r in report] == [r["layer"] for r in jreport]
    for a, b in zip(report, jreport):
        np.testing.assert_allclose(a["measured_var"], b["measured_var"],
                                   rtol=var_rtol)
        np.testing.assert_allclose(a["ratio"], b["ratio"], rtol=var_rtol)


@pytest.mark.parametrize("case", sorted(OWN_CASES))
def test_probe_is_the_compressor(graphs, case):
    """The probe measures what ``compressor.compress`` stashes: its codes
    are the stash's words, and its error is the stash's dequantized blocks
    against the projected input, over the real elements only."""
    from repro_torch.core import pack as packmod
    from repro_torch.core.compressor import compress
    from repro_torch.graph.analysis import _iter_layer_inputs

    comp = OWN_CASES[case]
    _, _, _, model, cfg, dg = _both(graphs, comp)
    got = measure_quant_health(model, dg, cfg, seed=0)
    tc = cfg.layer_compression()[0]
    for li, x in _iter_layer_inputs(model, dg, cfg):
        ls = layer_seed(0, li)
        ct = compress(x, tc, ls)
        xs = (backend.rp(x, ls ^ RP_SEED_SALT, x.shape[1] // tc.rp_ratio)
              if tc.rp_ratio > 1 else x)
        n = xs.numel()
        deq = backend.dequantize_blocks(ct.packed, ct.zero, ct.rng, tc.bits,
                                        tc.group_size, tc.levels())
        err = (deq.reshape(-1)[:n].double()
               - xs.reshape(-1).double()) ** 2
        codes = packmod.unpack(ct.packed, tc.bits, tc.group_size)
        top = 2 ** tc.bits - 1
        sat = ((codes == 0) | (codes == top)).reshape(-1)[:n]
        row = got[li]
        assert row["n_elements"] == n and row["n_blocks"] == ct.zero.numel()
        assert row["n_elements"] % tc.group_size  # a padded tail
        np.testing.assert_allclose(row["measured_var"], float(err.sum()),
                                   rtol=1e-5)
        assert row["sat_rate"] == pytest.approx(float(sat.double().mean()),
                                                rel=1e-6)
        rng = ct.rng.double()
        np.testing.assert_allclose(row["rng_sq_mean"],
                                   float((rng ** 2).mean()), rtol=1e-5)


def test_quant_monitor_history_and_epoch_tags(graphs):
    _, _, _, model, cfg, dg = _both(graphs)
    mon = QuantHealthMonitor(cfg)
    mon.probe(model, dg, 0)
    mon.probe(model, dg, 5)
    rows = mon.rows()
    assert rows and all(r["epoch"] == 5 for r in rows)
    hist = mon.history()
    assert [e for e, _ in hist] == [0, 5]
    # same weights, same seed: the probe replays bit-identically
    assert hist[0][1][0]["measured_var"] == hist[1][1][0]["measured_var"]


def test_probe_draws_from_no_generator(graphs):
    """The probe neither reads nor advances torch's global generator."""
    _, _, _, model, cfg, dg = _both(graphs)
    state = torch.get_rng_state()
    measure_quant_health(model, dg, cfg, seed=0)
    assert torch.equal(state, torch.get_rng_state())


# -------------------------------------------------------- obs calibration
def test_autoprec_obs_calibration_allocates(g):
    cfg = _cfg(g)
    base = ExecutionPlan(
        precision=PrecisionPolicy(kind="autoprec", bit_budget=2.0,
                                  calibration="obs"),
        obs=ObsPolicy(enabled=True, quant_stats=True))
    r = _run(g, cfg, base, n_epochs=2)
    assert len(r["bits_per_layer"]) == cfg.n_layers
    assert all(b in (1, 2, 4, 8) for b in r["bits_per_layer"])
    # the top-level spans: the solve's calibration pass holds gnn/spmm spans
    names = [s.name for s in r["obs"].tracer.spans if s.parent == -1]
    assert names[:3] == ["plan/compile", "autoprec/solve", "plan/recompile"]
    assert r["obs"].registry.snapshot()["engine/recompiles"] == 1
    assert r["obs"].registry.snapshot()["engine/forward_builds"] == 2


def test_obs_calibration_requires_telemetry_channel(g):
    plan = ExecutionPlan(
        precision=PrecisionPolicy(kind="autoprec", bit_budget=2.0,
                                  calibration="obs"))
    with pytest.raises(ValueError, match="quant_stats"):
        _run(g, _cfg(g), plan, n_epochs=1)


def test_policy_validation():
    with pytest.raises(ValueError, match="obs.quant_stats"):
        ObsPolicy(quant_stats=True)            # needs enabled=True
    with pytest.raises(ValueError, match="quant_stats_every"):
        ObsPolicy(enabled=True, quant_stats_every=0)
    with pytest.raises(ValueError, match="precision.calibration"):
        PrecisionPolicy(kind="autoprec", bit_budget=2.0,
                        calibration="bogus")
    with pytest.raises(ValueError, match="calibration"):
        PrecisionPolicy(kind="fixed", calibration="obs")
    p = dataclasses.replace(ExecutionPlan(), obs=ObsPolicy(enabled=True))
    assert "obs=trace+metrics" in p.describe()
    assert "obs" not in ExecutionPlan().describe()
    assert ExecutionPlan.from_legacy(obs=OBS).obs == OBS
    assert ExecutionPlan.from_legacy().obs == ObsPolicy()


# ------------------------------------------------------------------ pager
def test_pager_windowed_overlap():
    feats = np.random.default_rng(0).normal(
        size=(2, 1, 8, 4)).astype(np.float32)
    reg = MetricsRegistry()
    pg = FeaturePager(feats, "cpu", metrics=reg, window=3)
    for r in (0, 1, 0, 1, 0, 1):
        pg.fetch(r)
        pg.prefetch((r + 1) % 2)
    st = pg.stats()
    assert st["fetches"] == 6
    assert st["overlap_window_size"] == 3      # bounded, not lifetime
    assert 0.0 <= st["overlap_frac_window"] <= 1.0
    assert st["overlap_frac_window_min"] <= st["overlap_frac_window"]
    assert reg.counter("pager/fetches").value == 6
    assert reg.counter("pager/prefetch_hits").value == 5
    assert reg.histogram("pager/overlap_frac").count == 6
    assert reg.gauge("pager/round_bytes").value == feats.nbytes // 2
    assert reg.gauge("pager/host_bytes").value == feats.nbytes
    # without a registry the pager makes a private one: stats still live
    pg2 = FeaturePager(feats, "cpu")
    pg2.fetch(0)
    assert pg2.stats()["overlap_window_size"] == 1
