"""The mesh engine on the CPU against the JAX reference and against the
port's own engines: the halo program's tables, the byte counts, the
exchange (identities, and two ranks exchanging and differentiating), the
per-op compressed stack, the feature pager, the mesh's memory ledger, and
training: one partition, one rank, two ranks sharing a full-width mesh,
two ranks over four compressed partitions, and two data-parallel ranks of
the partition engine.

Setup: the reference's mini-batch test graph (700 nodes, 32 features, 5
classes), SAGE and GCN, hidden 32, G = 64, RP 8; the reference runs
``impl="jnp"`` and the port starts from the reference's weights
(``params_from_numpy``) where the two are compared.  Two-rank cases run in
two processes started by ``spawn`` in one gloo group over a ``FileStore``
(``repro_torch.parallel.run_ranks``, each with a timeout that kills and
fails); what a rank runs is in ``tests/torch_mesh_ranks.py``.  The
reference's own two-device mesh runs beside them in a process of its own
(``tests/jax_mesh_reference.py``: XLA takes its forced host device count
only when JAX starts), from the same weights.

Tolerances: halo tables, byte counts, ledgers and the exchange's forward
exactly; the exchange's backward against the dense transpose (float64)
atol 1e-5, and bit-identical from call to call; a world of one rank
against the port's ``train_gnn`` / ``train_gnn_batched(shuffle=False)``
bit for bit, and two data-parallel ranks against ``grad_accum=2`` bit for
bit; two ranks holding every partition (exact distributed full-graph
training) rtol 2e-4 / atol 2e-5 of ``train_gnn`` (the reference's gate:
the halo rows are summed in another order); against the reference rtol
1e-3 (as tests/test_torch_gnn.py: another summation order can flip a rare
SR code), and the two-rank parameters rtol 1e-3 / atol 1e-5 of the
reference's two-device ones.
"""
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core.act_compress import compressed_matmul as j_cmatmul
from repro.core.compressor import CompressionConfig as JCC
from repro.engine.plan import ExecutionPlan as JPlan
from repro.engine.plan import SamplingPolicy as JSampling
from repro.graph import data as j_data
from repro.graph.models import GNNConfig as JCfg
from repro.graph.models import init_gnn_params
from repro.graph.train import activation_memory_report as j_report
from repro.graph.train import train_gnn as j_train_gnn
from repro.graph.train import train_gnn_batched as j_train_batched
from repro.parallel import halo as j_halo
from repro_torch.core import act_compress as t_ac
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.engine.plan import (ExecutionPlan, KernelPolicy,
                                     PrecisionPolicy, SamplingPolicy,
                                     StashPolicy)
from repro_torch.engine.runner import run as t_run
from repro_torch.graph import data as t_data
from repro_torch.graph.models import GNNConfig as TCfg
from repro_torch.graph.models import (adjacency, aggregate, params_from_numpy,
                                      relu_1bit)
from repro_torch.graph.train import activation_memory_report as t_report
from repro_torch.graph.train import train_gnn as t_train_gnn
from repro_torch.graph.train import train_gnn_batched as t_train_batched
from repro_torch.graph.train import train_gnn_mesh as t_train_mesh
from repro_torch.offload.gnn import plan_gnn_stashes
from repro_torch.offload.pager import FeaturePager
from repro_torch.parallel import halo as t_halo
from repro_torch.parallel import run_ranks

GRAPH_ARGS = ranks.GRAPH_ARGS
GRAPH_KW = ranks.GRAPH_KW
PROGRAM_FIELDS = ("n_parts", "group", "rounds", "n_pad", "e_pad", "halo",
                  "part", "features", "labels", "train_mask", "node_mask",
                  "edge_src", "edge_dst", "gcn_weight", "mean_weight",
                  "send_idx", "n_real_nodes", "n_real_edges",
                  "dropped_edges", "halo_edges")
#: Seconds a two-rank case may take before its ranks are killed and it
#: fails (a case takes about 3 s).
RANKS_TIMEOUT = 60.0
#: The reference's two-device mesh run (a script of its own, see the
#: module docstring) and the source tree it imports.
REFERENCE_SCRIPT = Path(__file__).with_name("jax_mesh_reference.py")
SRC = Path(__file__).resolve().parents[1] / "src"


@functools.lru_cache(maxsize=None)
def _graphs():
    return (j_data.synthetic_graph(*GRAPH_ARGS, **GRAPH_KW),
            t_data.synthetic_graph(*GRAPH_ARGS, **GRAPH_KW))


def _cfgs(arch="sage", comp=True, hidden=(32,)):
    jc = JCC(bits=2, group_size=64, rp_ratio=8) if comp else None
    tc = ranks.INT2 if comp else None
    return (JCfg(arch=arch, hidden=hidden, n_classes=5, compression=jc),
            TCfg(arch=arch, hidden=hidden, n_classes=5, compression=tc))


def _carried(jcfg, tcfg, seed=0):
    jp = init_gnn_params(jax.random.PRNGKey(seed), jcfg, GRAPH_ARGS[3])
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return jp, params_from_numpy(npp, tcfg, device="cpu")


def _losses(res):
    return [h[1] for h in res["history"]]


def _same_params(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))


def _start_reference(tmp_path, arch, compressed, n_parts, n_epochs):
    """Start the reference's ``train_gnn_mesh`` on two forced host devices
    in a process of its own; :func:`_reference_result` collects it."""
    out = tmp_path / "reference.npz"
    path = os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, str(REFERENCE_SCRIPT), arch,
         "1" if compressed else "0", str(n_parts), str(n_epochs), str(out)],
        env=dict(os.environ, PYTHONPATH=path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, out


def _reference_result(started, tcfg):
    """The reference run's losses and final parameters (as the port's
    ``parameters()``); kills it and fails after ``RANKS_TIMEOUT``."""
    proc, out = started
    try:
        log, _ = proc.communicate(timeout=RANKS_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"the reference's mesh run took over {RANKS_TIMEOUT} s")
    assert proc.returncode == 0, log
    d = np.load(out)
    n_layers = len(tcfg.hidden) + 1
    params = [{"w": d[f"w{i}"], "b": d[f"b{i}"]} for i in range(n_layers)]
    model = params_from_numpy(params, tcfg, device="cpu")
    return list(d["losses"]), [p.detach().numpy() for p in model.parameters()]


# ------------------------------------------------------------ halo program
@pytest.mark.parametrize("method", ["bfs", "random"])
@pytest.mark.parametrize("n_parts,m", [(4, 1), (4, 2), (4, 4), (3, 1)])
def test_halo_program_equal_to_reference(method, n_parts, m):
    jg, tg = _graphs()
    jp = j_halo.build_halo_program(jg, n_parts, m, method=method, seed=3)
    tp = t_halo.build_halo_program(tg, n_parts, m, method=method, seed=3)
    for f in PROGRAM_FIELDS:
        a, b = getattr(tp, f), getattr(jp, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f)
    # the port's send counts: real slots first, pad slots gather row 0
    H = tp.halo
    assert tp.send_count.shape == (tp.rounds, m, m)
    assert tp.send_count.max(initial=0) == H
    pad = np.arange(H) >= tp.send_count[..., None]
    assert not tp.send_idx[pad].any()
    # every edge is kept once or dropped; m == n_parts drops none
    assert int(tp.n_real_edges.sum()) + tp.dropped_edges == tg.n_edges
    if m == n_parts:
        assert tp.dropped_edges == 0


def test_halo_program_rejects_indivisible_group():
    _, tg = _graphs()
    with pytest.raises(ValueError, match="multiple"):
        t_halo.build_halo_program(tg, 3, 2)


def test_exchange_widths_and_bytes_equal_to_reference():
    jg, tg = _graphs()
    dims = [32, 64, 16, 5]
    for arch in ("gcn", "sage"):
        assert (t_halo.exchange_widths(arch, dims)
                == j_halo.exchange_widths(arch, dims))
    assert t_halo.exchange_widths("sage", dims) == (32, 64, 16)
    for n_parts, m in ((4, 2), (4, 4), (2, 1)):
        jp = j_halo.build_halo_program(jg, n_parts, m)
        tp = t_halo.build_halo_program(tg, n_parts, m)
        for widths in ((64, 5), (32, 64, 16)):
            assert (t_halo.halo_bytes_per_epoch(tp, widths)
                    == j_halo.halo_bytes_per_epoch(jp, widths))
            assert (t_halo.halo_bytes_per_round(tp, widths)
                    == j_halo.halo_bytes_per_round(jp, widths))
    assert t_halo.build_halo_program(tg, 2, 1).halo == 0


def test_rank_round_tables():
    """A rank's tables: the extended A is n_pad x (n_pad + m*H) and its
    transpose the other way round; the exchange's backward sums the real
    send slots only."""
    _, tg = _graphs()
    tp = t_halo.build_halo_program(tg, 4, 2)
    n, width = tp.n_pad, tp.n_pad + 2 * tp.halo
    for r in range(tp.rounds):
        for rank in range(2):
            t = t_halo.rank_round(tp, r, rank, "sage", "cpu")
            assert t.adj.fwd.offsets.shape[0] == n + 1
            assert t.adj.bwd.offsets.shape[0] == width + 1
            assert int(t.back.offsets[-1]) == int(tp.send_count[r, rank]
                                                  .sum())
            assert t.labels.dtype == torch.int64
            np.testing.assert_array_equal(t.send_idx.numpy(),
                                          tp.send_idx[r, rank])


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("kw,match", [
    (dict(grad_accum=2), "grad_accum"), (dict(halo=1), "structural"),
    (dict(renormalize=True), "renormalize")])
def test_mesh_plan_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        SamplingPolicy(kind="mesh", n_parts=4, **kw)
    with pytest.raises(ValueError, match=match):
        JSampling(kind="mesh", n_parts=4, **kw)


@pytest.mark.parametrize("change,match", [
    (dict(stash=StashPolicy(kind="arena", placement="device")),
     "host-resident"),
    (dict(kernel=KernelPolicy(fused="on")), "fused"),
    (dict(precision=PrecisionPolicy(kind="autoprec", bit_budget=2.0)),
     "autoprec"),
    (dict(batches=True), "prebuilt")])
def test_mesh_compile_refusals(change, match):
    _, tg = _graphs()
    _, tcfg = _cfgs()
    change = dict(change)
    batches = [] if change.pop("batches", False) else None
    plan = ExecutionPlan(sampling=SamplingPolicy(kind="mesh", n_parts=2),
                         **change)
    with pytest.raises(ValueError, match=match):
        t_run(tg, tcfg, plan, n_epochs=1, device="cpu", batches=batches)


def test_mesh_plan_describe_and_hash():
    plan = ExecutionPlan(sampling=SamplingPolicy(kind="mesh", n_parts=4,
                                                 shuffle=False))
    assert hash(plan)
    assert "mesh x4 (bfs)" in plan.describe()


# ----------------------------------------------------------- the exchange
def test_halo_exchange_identities():
    h = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    for shape, group in (((4, 0), object()), ((1, 3), object()),
                         ((4, 3), None)):
        send = np.zeros(shape, np.int64)
        back = t_halo.send_csr(send, np.full(shape[0], shape[1]), 6, "cpu")
        assert t_halo.halo_exchange(h, torch.from_numpy(send), back,
                                    group) is h


def test_graph_mesh_without_a_group_is_one_rank():
    assert t_halo.graph_mesh(3) is None
    assert t_halo.dp_size(None) == 1 and t_halo.group_rank(None) == 0


def test_halo_exchange_two_ranks():
    """On rank j the strip slot (i, s) holds h_i[send_i[j, s]] exactly; the
    backward (through send_csr, as training builds it) is the dense
    transpose over the real slots (the strip's gradient returned to its
    sender and added into the sent rows; pad slots send none back),
    bit-identical from call to call; a group of 2 refuses 3 partitions."""
    n, H, f = 16, 3, 8
    got = run_ranks(ranks.exchange, 2, (n, H, f), timeout=RANKS_TIMEOUT)
    h, send, count, g = ranks.exchange_case(2, n, H, f)
    for j in range(2):
        out = got[j]["out"][0]
        assert out.shape == (n + 2 * H, f)
        np.testing.assert_array_equal(out[:n], h[j])
        for i in range(2):
            np.testing.assert_array_equal(out[n + i * H:n + (i + 1) * H],
                                          h[i][send[i, j]])
        want = g[j][:n].astype(np.float64)
        for i in range(2):
            for s in range(count[j, i]):
                want[send[j, i, s]] += g[i][n + j * H + s]
        np.testing.assert_allclose(got[j]["grad"][0], want, rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got[j]["out"][0], got[j]["out"][1])
        np.testing.assert_array_equal(got[j]["grad"][0], got[j]["grad"][1])
        assert got[j]["refused"]


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.fail_on_rank_1, 2, timeout=RANKS_TIMEOUT)


def test_run_ranks_kills_a_hung_rank():
    """A rank still running at the timeout is killed and the call raises;
    it never waits for the rank's own end."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1: still running"):
        run_ranks(ranks.hang_on_rank_1, 2, (600.0,), timeout=15.0)
    assert time.monotonic() - t0 < 60.0


# ------------------------------------------------------ per-op primitives
@pytest.mark.parametrize("rp", [0, 8])
def test_compressed_matmul_matches_reference(rp):
    """The same stash codes (the bit contract), so the forward and dx agree
    to float32 rounding and dw, read at the reconstruction, too."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(96, 64)).astype(np.float32)
    w = rng.normal(size=(64, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    g = rng.normal(size=(96, 24)).astype(np.float32)
    jc = JCC(bits=2, group_size=64, rp_ratio=rp, impl="jnp")
    tc = TCC(bits=2, group_size=64, rp_ratio=rp)
    seed = 1234

    def j_loss(x, w, b):
        y = j_cmatmul(x, w, jnp.uint32(seed), jc) + b
        return jnp.sum(y * g), y

    (_, jy), jgr = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                      has_aux=True)(
        *(jnp.asarray(a) for a in (x, w, b)))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    ty = t_ac.compressed_linear(tx, tw, tb, seed, tc)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for t, j in zip((tx, tw, tb), jgr):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-4)
    assert t_ac.stash_nbytes(ty) == t_ac.compress(
        tx.detach(), tc, seed).nbytes
    # compressed_matmul is the same without the bias
    tx2 = torch.tensor(x, requires_grad=True)
    y2 = t_ac.compressed_matmul(tx2, tw.detach(), seed, tc)
    y2.backward(torch.from_numpy(g))
    assert torch.equal(tx2.grad, tx.grad)


@pytest.mark.parametrize("call", [
    lambda: t_ac.compressed_matmul(torch.ones(4, 4), torch.ones(4, 4), 0,
                                   TCC(group_size=16), offload="host"),
    lambda: t_ac.compressed_elementwise(torch.relu, torch.ones(4), 0,
                                        TCC()),
    lambda: t_ac.compressed_block(lambda x, p: x, TCC())])
def test_lm_parts_of_act_compress_raise(call):
    with pytest.raises(NotImplementedError, match="A.11"):
        call()


def test_relu_1bit_and_aggregate_gradients():
    """relu_1bit's backward reads the packed mask; aggregate's is the
    transpose, as autograd's through the dense matrix."""
    rng = np.random.default_rng(1)
    z = torch.tensor(rng.normal(size=(50, 7)).astype(np.float32),
                     requires_grad=True)
    relu_1bit(z).backward(torch.ones(50, 7))
    np.testing.assert_array_equal(z.grad.numpy(),
                                  (z.detach().numpy() > 0).astype(np.float32))
    src = rng.integers(0, 60, 200)
    dst = rng.integers(0, 50, 200)
    w = rng.random(200).astype(np.float32)
    adj = adjacency(src, dst, w, 50, "cpu", n_src=60)
    h = torch.tensor(rng.normal(size=(60, 5)).astype(np.float32),
                     requires_grad=True)
    dense = torch.zeros(50, 60, dtype=torch.float64)
    dense.index_put_((torch.from_numpy(dst), torch.from_numpy(src)),
                     torch.from_numpy(w).double(), accumulate=True)
    g = torch.tensor(rng.normal(size=(50, 5)).astype(np.float32))
    out = aggregate(h, adj)
    out.backward(g)
    np.testing.assert_allclose(out.detach().numpy(),
                               (dense @ h.detach().double()).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), (dense.T @ g.double()).numpy(),
                               atol=1e-5)


# ------------------------------------------------------------- the pager
def test_feature_pager_round_trip_and_stats():
    rng = np.random.default_rng(0)
    feats = rng.normal(0, 1, (3, 2, 100, 16)).astype(np.float32)
    pager = FeaturePager(feats, "cpu", rank=1, page_rows=32)
    assert pager.n_pages == 4       # ceil(100 / 32)
    pager.prefetch(0)
    for r in range(3):
        got = pager.fetch(r)
        np.testing.assert_array_equal(got.numpy(), feats[r, 1])
        pager.prefetch((r + 1) % 3)
    st = pager.stats()
    assert st["fetches"] == 3 and st["prefetch_hits"] == 3
    assert st["round_bytes"] == 100 * 16 * 4
    assert st["host_bytes"] == 3 * st["round_bytes"]
    assert st["host_kind"] == "pageable"
    assert 0.0 <= st["overlap_frac"] <= 1.0
    assert st["overlap_window_size"] == 3
    # a fetch without its prefetch is no hit
    pager2 = FeaturePager(feats, "cpu")
    np.testing.assert_array_equal(pager2.fetch(2).numpy(), feats[2, 0])
    assert pager2.stats()["prefetch_hits"] == 0
    assert pager2.page_rows == (1 << 15) // 16


def test_feature_pager_refusals():
    with pytest.raises(ValueError, match="rounds, m, n_pad, F"):
        FeaturePager(np.zeros((2, 3, 4), np.float32), "cpu")
    with pytest.raises(NotImplementedError, match="A.10"):
        FeaturePager(np.zeros((1, 1, 4, 2), np.float32), "cpu",
                     metrics=object())


# ------------------------------------------------------- the byte ledger
@pytest.mark.parametrize("comp", [True, False])
@pytest.mark.parametrize("n_parts", [4, 8])
def test_mesh_memory_report_equal_to_reference(comp, n_parts):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(comp=comp, hidden=(64, 64))
    jplan = JPlan(sampling=JSampling(kind="mesh", n_parts=n_parts))
    tplan = ExecutionPlan(sampling=SamplingPolicy(kind="mesh",
                                                  n_parts=n_parts))
    want = j_report(jg, jcfg, plan=jplan)
    got = t_report(tg, tcfg, plan=tplan)
    assert got == want
    assert "mesh" in got and "batched" not in got


def test_mesh_per_device_ledger_at_least_2x_smaller():
    """A 4-partition mesh's per-rank stash plan is at least 2x below the
    full-graph plan at the same config (the reference's gate)."""
    g = t_data.papers100m_like(2e-5)
    cfg = TCfg(hidden=(128,), n_classes=g.num_classes,
               compression=TCC(bits=2, group_size=32))
    full = plan_gnn_stashes(cfg, g.n_feats, g.n_nodes)
    prog = t_halo.build_halo_program(g, 4, 4)
    per_rank = plan_gnn_stashes(cfg, g.n_feats, prog.n_pad)
    assert full.total_bytes / per_rank.total_bytes >= 2.0


# ------------------------------------------------------ training, one rank
def test_mesh_one_partition_is_train_gnn():
    """n_parts=1 with exact padding: the port's train_gnn bit for bit, and
    the reference's train_gnn within rtol 1e-3."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs()
    _, model = _carried(jcfg, tcfg)
    full = t_train_gnn(tg, tcfg, n_epochs=3, seed=0, params=model,
                       device="cpu")
    mesh = t_train_mesh(tg, tcfg, 1, n_epochs=3, seed=0, params=model,
                        node_multiple=1, edge_multiple=1, device="cpu")
    assert _losses(mesh) == _losses(full)
    assert _same_params(mesh["model"], full["model"])
    assert mesh["mesh_devices"] == 1 and mesh["halo_bytes_per_epoch"] == 0
    assert mesh["halo_bytes_sent"] == 0
    ref = j_train_gnn(jg, jcfg, n_epochs=3, seed=0, impl="jnp",
                      verbose=True, eval_every=1)
    np.testing.assert_allclose(_losses(mesh), _losses(ref), rtol=1e-3)


@pytest.mark.parametrize("arch", ["gcn", "sage"])
def test_mesh_one_rank_is_batched(arch):
    """A 3-partition mesh on one rank is train_gnn_batched(shuffle=False)
    bit for bit (losses, params, the live stash), and the reference's
    within rtol 1e-3; the stash is the mesh ledger and the pager hits
    every round."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    _, model = _carried(jcfg, tcfg)
    batched = t_train_batched(tg, tcfg, 3, n_epochs=3, seed=0, params=model,
                              shuffle=False, device="cpu")
    mesh = t_train_mesh(tg, tcfg, 3, n_epochs=3, seed=0, params=model,
                        device="cpu")
    assert _losses(mesh) == _losses(batched)
    assert _same_params(mesh["model"], batched["model"])
    assert mesh["stash_bytes"] == batched["stash_bytes"]
    for k in ("n_parts", "updates_per_epoch", "batch_nodes",
              "batch_edges"):
        assert mesh[k] == batched[k], k
    plan = ExecutionPlan(sampling=SamplingPolicy(kind="mesh", n_parts=3))
    ledger = t_report(tg, tcfg, plan=plan, batch_nodes=mesh["batch_nodes"])
    assert mesh["stash_bytes"] == [r["compressed_bytes"] for r in
                                   ledger["mesh"]["per_layer"]]
    st = mesh["pager"]
    assert st["fetches"] == st["prefetch_hits"] == 9
    ref = j_train_batched(jg, jcfg, 3, n_epochs=3, seed=0, impl="jnp",
                          shuffle=False, verbose=True, eval_every=1)
    np.testing.assert_allclose(_losses(mesh), _losses(ref), rtol=1e-3)


# ----------------------------------------------------- training, two ranks
def _assert_near_reference(res, want, tcfg):
    """Losses and parameters rtol 1e-3 (parameters atol 1e-5) of the
    reference's two-device run."""
    losses, params = _reference_result(want, tcfg)
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-3)
    for p, q in zip(res["params"], params):
        np.testing.assert_allclose(p, q, rtol=1e-3, atol=1e-5)


def test_mesh_two_ranks_full_width_matches_train_gnn(tmp_path):
    """n_parts = m = 2, uncompressed, from the reference's weights: every
    edge kept, both ranks end with the same parameters, within rtol 2e-4 /
    atol 2e-5 of train_gnn and rtol 1e-3 of the reference's two-device
    mesh; the exchanged bytes are the program's."""
    jcfg, tcfg = _cfgs("sage", comp=False)
    jp, model = _carried(jcfg, tcfg)
    want = _start_reference(tmp_path, "sage", False, 2, 2)
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    got = run_ranks(ranks.train, 2, ("mesh", "sage", False,
                                     dict(n_parts=2, n_epochs=2), "cpu", npp),
                    timeout=RANKS_TIMEOUT)
    _, tg = _graphs()
    ref = t_train_gnn(tg, tcfg, n_epochs=2, seed=0, params=model,
                      device="cpu")
    a, b = got
    assert a["mesh_devices"] == 2 and a["dropped_edges"] == 0
    assert a["halo_width"] > 0
    assert (a["halo_bytes_sent"] + b["halo_bytes_sent"]
            == 2 * a["halo_bytes_per_epoch"])
    assert a["losses"] == b["losses"]
    np.testing.assert_allclose(a["losses"], _losses(ref), rtol=2e-4)
    for pa, pb, pr in zip(a["params"], b["params"],
                          ref["model"].parameters()):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_allclose(pa, pr.detach().numpy(), rtol=2e-4,
                                   atol=2e-5)
    _assert_near_reference(a, want, tcfg)


def test_mesh_two_ranks_compressed_trains_and_pages(tmp_path):
    """4 compressed partitions on 2 ranks (2 rounds), from the reference's
    weights: losses and parameters near the reference's two-device mesh
    (each rank's SR seeds and halo slots as the reference's), a falling
    loss, the pager hitting every round, each rank's stash the mesh ledger
    and the bytes exchanged the program's."""
    epochs = 4
    jcfg, tcfg = _cfgs("gcn")
    jp, _ = _carried(jcfg, tcfg)
    want = _start_reference(tmp_path, "gcn", True, 4, epochs)
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    got = run_ranks(ranks.train, 2, ("mesh", "gcn", True,
                                     dict(n_parts=4, n_epochs=epochs), "cpu",
                                     npp),
                    timeout=RANKS_TIMEOUT)
    _, tg = _graphs()
    plan = ExecutionPlan(sampling=SamplingPolicy(kind="mesh", n_parts=4))
    a, b = got
    ledger = t_report(tg, tcfg, plan=plan, batch_nodes=a["batch_nodes"])
    for res in got:
        assert res["updates_per_epoch"] == 2
        assert all(np.isfinite(res["losses"]))
        assert res["losses"][-1] < res["losses"][0]
        st = res["pager"]
        assert st["prefetch_hits"] == st["fetches"] == 2 * epochs
        assert st["host_bytes"] >= st["round_bytes"] * 2
        assert res["stash_bytes"] == [r["compressed_bytes"] for r in
                                      ledger["mesh"]["per_layer"]]
    assert (a["halo_bytes_sent"] + b["halo_bytes_sent"]
            == epochs * a["halo_bytes_per_epoch"])
    for pa, pb in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(pa, pb)
    _assert_near_reference(a, want, tcfg)


@pytest.mark.parametrize("shuffle", [False, True])
def test_batched_two_ranks_is_grad_accum_2(shuffle):
    """train_gnn_batched over two data-parallel ranks is one process at
    grad_accum=2 bit for bit: the same batches at the same positions and
    seeds, and 0 + g0 + g1 == g0 + g1."""
    got = run_ranks(ranks.train, 2, ("batched", "sage", True,
                                     dict(n_parts=4, n_epochs=2,
                                          shuffle=shuffle)),
                    timeout=RANKS_TIMEOUT)
    _, tg = _graphs()
    cfg = ranks.config("sage", True)
    ref = t_train_batched(tg, cfg, 4, n_epochs=2, seed=0,
                          params=ranks.model(cfg), grad_accum=2,
                          shuffle=shuffle, device="cpu")
    for res in got:
        assert res["losses"] == _losses(ref)
        assert res["updates_per_epoch"] == 2
        for p, q in zip(res["params"], ref["model"].parameters()):
            np.testing.assert_array_equal(p, q.detach().numpy())
