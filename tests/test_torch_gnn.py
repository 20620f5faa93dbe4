"""The slice as a whole on the CPU: the port's full-graph i-EXACT training
against the JAX reference from the same graph and the same carried weights.

Setup: arxiv-like at scale 0.004 (677 nodes, so no layer's element count is
whole blocks of 256: the ragged tail is live), hidden (64, 64), INT2, G=256,
RP 8, VM levels.  Tolerance for losses and gradients: rtol 1e-3, because
the matmuls and the sparse aggregation sum in another order than XLA, and a
last-ulp difference can flip a rare stochastic-rounding code in a deeper
layer."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressor import CompressionConfig as JCC
from repro.core.compressor import compress as j_compress
from repro.engine import seeds as j_seeds
from repro.engine.compile import engine_loss
from repro.engine.forward import TENSOR_STASH, plan_gnn_stashes
from repro.graph import analysis as j_analysis
from repro.graph.data import arxiv_like as j_arxiv_like
from repro.graph.data import cora_like as j_cora_like
from repro.graph.models import GNNConfig as JCfg
from repro.graph.models import gnn_forward, graph_tuple, init_gnn_params, spmm
from repro.graph.train import train_gnn as j_train_gnn
from repro.optim import AdamWConfig as JAdam
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.engine.compile import masked_nll
from repro_torch.engine.forward import stash_gnn_forward, stash_nbytes
from repro_torch.graph import analysis as t_analysis
from repro_torch.graph import models as t_models
from repro_torch.graph.data import arxiv_like as t_arxiv_like
from repro_torch.graph.data import cora_like as t_cora_like
from repro_torch.graph.models import GNNConfig as TCfg
from repro_torch.graph.models import device_graph, params_from_numpy
from repro_torch.graph.models import spmm as t_spmm
from repro_torch.graph.train import train_gnn as t_train_gnn
from repro_torch.optim import AdamWConfig as TAdam
from repro_torch.optim import adamw_init as t_adamw_init
from repro_torch.optim import adamw_update as t_adamw_update

ARCHS = ["sage", "gcn"]


@functools.lru_cache(maxsize=None)
def _graphs():
    return j_arxiv_like(scale=0.004), t_arxiv_like(scale=0.004)


def _cfgs(arch, vm=True):
    return (JCfg(arch=arch, hidden=(64, 64), n_classes=40,
                 compression=JCC(2, 256, 8, vm=vm)),
            TCfg(arch=arch, hidden=(64, 64), n_classes=40,
                 compression=TCC(2, 256, 8, vm=vm)))


def _carried(jcfg, tcfg, in_dim, seed=0):
    jp = init_gnn_params(jax.random.PRNGKey(seed), jcfg, in_dim)
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return jp, params_from_numpy(npp, tcfg)


@pytest.mark.parametrize("make", [(j_arxiv_like, t_arxiv_like, 0.004),
                                  (j_cora_like, t_cora_like, 0.2)])
def test_same_graph_from_same_seed(make):
    jf, tf, scale = make
    jg, tg = jf(scale=scale, seed=3), tf(scale=scale, seed=3)
    for f in ("features", "labels", "edge_src", "edge_dst", "gcn_weight",
              "mean_weight", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    assert tg.num_classes == jg.num_classes


@pytest.mark.parametrize("arch", ARCHS)
def test_primal_forward_and_spmm_match_reference(arch):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    jp, model = _carried(jcfg, tcfg, tg.n_feats)
    dg = device_graph(tg, arch, "cpu")
    with torch.no_grad():
        got = model(dg).numpy()
    want = np.asarray(gnn_forward(jp, graph_tuple(jg), jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    w = jg.mean_weight if arch == "sage" else jg.gcn_weight
    h = np.random.default_rng(0).normal(size=(tg.n_nodes, 8)).astype(np.float32)
    for a, (s, d) in ((dg.adj.fwd, ("edge_src", "edge_dst")),
                      (dg.adj.bwd, ("edge_dst", "edge_src"))):
        want = spmm(jnp.asarray(h), getattr(jg, s), getattr(jg, d), w,
                    tg.n_nodes)
        np.testing.assert_allclose(t_spmm(torch.from_numpy(h), a).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_edges", [1, 7, 500])
def test_spmm_row_runs_change_no_bits(max_edges):
    """Cutting the rows into runs of bounded edge count (the gathered
    transient's bound) leaves every row's sum, and so every bit, as one
    pass gives; empty rows and rows heavier than the budget included."""
    _, tg = _graphs()
    h = torch.from_numpy(np.random.default_rng(1).normal(
        size=(tg.n_nodes, 8)).astype(np.float32))
    s, d, w = tg.edge_src.numpy(), tg.edge_dst.numpy(), tg.mean_weight.numpy()
    keep = d != 5                       # leave row 5 without edges
    one = t_models._csr(d[keep], s[keep], w[keep], tg.n_nodes, "cpu",
                        max_edges=1 << 30)
    cut = t_models._csr(d[keep], s[keep], w[keep], tg.n_nodes, "cpu",
                        max_edges=max_edges)
    assert len(one.parts) == 1 and len(cut.parts) > 1
    assert all(e1 - e0 <= max_edges or r1 - r0 == 1
               for r0, r1, e0, e1, _ in cut.parts)
    got = t_spmm(h, cut)
    assert torch.equal(got, t_spmm(h, one))
    assert not got[5].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_layer0_stash_words_bit_equal(arch):
    """Epoch 0, layer 0: the stash the port's forward keeps holds the words
    JAX's compress writes for the same layer input and seed."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    _, model = _carried(jcfg, tcfg, tg.n_feats)
    sr = int(j_seeds.sr_seed(0))
    logits = stash_gnn_forward(model, device_graph(tg, arch, "cpu"), tcfg, sr)
    ct = logits.grad_fn.stash[0]["ct"]
    feats, src, dst, gcn_w, mean_w = graph_tuple(jg)
    x = (jnp.concatenate([feats, spmm(feats, src, dst, mean_w, tg.n_nodes)],
                         axis=1) if arch == "sage" else feats)
    jct = j_compress(x, jcfg.compression, j_seeds.layer_seed(sr, 0),
                     impl="jnp")
    assert (ct.packed.numel() * 16) % 256 == 0 and x.size % 2048
    np.testing.assert_array_equal(ct.packed.numpy(),
                                  np.asarray(jct.packed).view(np.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_gradients_match_reference(arch):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    jp, model = _carried(jcfg, tcfg, tg.n_feats)
    sr = j_seeds.sr_seed(0)
    splan = plan_gnn_stashes(jcfg, jg.n_feats, jg.n_nodes)
    loss_j, grads_j = jax.value_and_grad(engine_loss)(
        jp, graph_tuple(jg), jg.labels, jg.train_mask.astype(jnp.float32),
        jcfg, sr, None, splan, TENSOR_STASH)
    dg = device_graph(tg, arch, "cpu")
    logits = stash_gnn_forward(model, dg, tcfg, int(sr))
    loss_t = masked_nll(logits, dg.labels, dg.train_mask)
    grads_t = torch.autograd.grad(loss_t, model.flat_params())
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = [np.asarray(g[k]) for g in grads_j for k in ("w", "b")]
    for got, w in zip(grads_t, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_three_epochs_match_reference_train_gnn(arch):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    _, model = _carried(jcfg, tcfg, tg.n_feats)
    rj = j_train_gnn(jg, jcfg, n_epochs=3, seed=0, verbose=True, eval_every=1,
                     impl="jnp")
    rt = t_train_gnn(tg, tcfg, n_epochs=3, seed=0, params=model, device="cpu")
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-3)
    assert abs(rt["val_acc"] - rj["val_acc"]) < 0.02
    ledger = [r["compressed_bytes"] for r in
              t_analysis.saved_bytes_per_layer(tcfg, tg.n_feats, tg.n_nodes)]
    assert rt["stash_bytes"] == ledger
    # the carried-in weights are left as they were
    np.testing.assert_array_equal(model.weights[0].detach().numpy(),
                                  np.asarray(init_gnn_params(
                                      jax.random.PRNGKey(0), jcfg,
                                      jg.n_feats)[0]["w"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("nodes", [677, 1000, 2**12 + 1])
def test_saved_bytes_ledger_matches_reference(arch, nodes):
    jcfg, tcfg = _cfgs(arch)
    assert (t_analysis.saved_bytes_per_layer(tcfg, 128, nodes)
            == j_analysis.saved_bytes_per_layer(jcfg, 128, nodes))
    assert t_analysis.relu_mask_nbytes(nodes) == \
        j_analysis.relu_mask_nbytes(nodes)


def test_stash_holds_only_compressed_tensors_and_masks():
    _, tg = _graphs()
    _, tcfg = _cfgs("sage")
    _, model = _carried(*_cfgs("sage"), tg.n_feats)
    logits = stash_gnn_forward(model, device_graph(tg, "sage", "cpu"), tcfg, 7)
    stash = logits.grad_fn.stash
    assert [sorted(e) for e in stash] == [["ct", "mask"], ["ct", "mask"],
                                          ["ct"]]
    assert sum(stash_nbytes(logits)) < 0.1 * tg.n_nodes * (256 + 128) * 4


def test_autograd_saves_only_the_params():
    """No f32 activation (``h[src]``, the concat, the ReLU input) reaches
    autograd's saved tensors: the one Function saves the params alone."""
    _, tg = _graphs()
    _, tcfg = _cfgs("sage")
    _, model = _carried(*_cfgs("sage"), tg.n_feats)
    dg = device_graph(tg, "sage", "cpu")
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        stash_gnn_forward(model, dg, tcfg, 7)
    params = model.flat_params()
    assert len(saved) == len(params)
    assert all(s.data_ptr() == p.data_ptr() for s, p in zip(saved, params))


def test_uncompressed_config_trains_like_reference():
    jg, tg = _graphs()
    jcfg = JCfg(arch="sage", hidden=(32,), n_classes=40)
    tcfg = TCfg(arch="sage", hidden=(32,), n_classes=40)
    _, model = _carried(jcfg, tcfg, tg.n_feats)
    rj = j_train_gnn(jg, jcfg, n_epochs=2, seed=0, verbose=True, eval_every=1)
    rt = t_train_gnn(tg, tcfg, n_epochs=2, seed=0, params=model, device="cpu")
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-4)


def test_adamw_matches_reference():
    rs = np.random.default_rng(0)
    shapes = [(5, 3), (3,)]
    ps = [rs.normal(size=s).astype(np.float32) for s in shapes]
    for cfg_kw in ({"lr": 5e-3}, {"lr": 1e-2, "weight_decay": 0.1,
                                  "grad_clip": 0.5, "warmup_steps": 2,
                                  "decay_steps": 5}):
        jp, tp = [jnp.asarray(p) for p in ps], [torch.from_numpy(p.copy())
                                                 for p in ps]
        jcfg, tcfg = JAdam(**cfg_kw), TAdam(**cfg_kw)
        js, ts = j_adamw_init(jp, jcfg), t_adamw_init(tp)
        for step in range(4):
            gs = [rs.normal(size=s).astype(np.float32) for s in shapes]
            jp, js = j_adamw_update([jnp.asarray(g) for g in gs], js, jp, jcfg)
            t_adamw_update([torch.from_numpy(g) for g in gs], ts, tp, tcfg)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    with pytest.raises(NotImplementedError):
        TAdam(state_bits=8)


def test_train_gnn_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tg = _graphs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train_gnn(tg, _cfgs("sage")[1], n_epochs=1)
