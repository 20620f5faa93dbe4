"""The fused matmul-quantize pair of the port against the JAX reference, on
the CPU: the plain versions, the orchestrators, the routing, and full-graph
training with ``rp_ratio=0`` (the configuration whose layers all fuse).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: packed words, zero and range are bit-equal (the same counter
hash and pack); ``y`` and ``dw`` are within rtol/atol 1e-5 (two CPU matmul
libraries may sum in another order); training losses within rtol 1e-3 (an
ulp can flip a rare SR code in a deeper layer).  The reference's interpret-
mode backward is compared at float tolerance only, never for bit equality.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as j_backend
from repro.core import compressor as j_comp
from repro.engine import seeds as j_seeds
from repro.graph.data import arxiv_like as j_arxiv_like
from repro.graph.models import GNNConfig as JCfg
from repro.graph.models import graph_tuple, init_gnn_params, spmm
from repro.graph.train import train_gnn as j_train_gnn
from repro.kernels import ops as j_ops
from repro_torch.core import backend as t_backend
from repro_torch.core import compressor as t_comp
from repro_torch.core.variance import optimize_levels
from repro_torch.engine.forward import stash_gnn_forward
from repro_torch.graph import analysis as t_analysis
from repro_torch.graph.data import arxiv_like as t_arxiv_like
from repro_torch.graph.models import GNNConfig as TCfg
from repro_torch.graph.models import device_graph, params_from_numpy
from repro_torch.graph.train import train_gnn as t_train_gnn
from repro_torch.kernels import build
from repro_torch.kernels import fused_matmul as t_fk
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from torch_threads import one_thread  # noqa: F401

SHAPES = [(96, 64, 64), (9, 64, 64), (10, 32, 64), (100, 64, 32)]
N_OUT = 24


def _inputs(m, d, n=N_OUT):
    rs = np.random.default_rng(m * 1000 + d)
    x = (rs.normal(size=(m, d)) * 1.7 + 0.3).astype(np.float32)
    w = (rs.normal(size=(d, n)) / np.sqrt(d)).astype(np.float32)
    g = (rs.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    return x, w, g


def _levels(vm, g, bits):
    return optimize_levels(g, bits) if vm else None


@pytest.mark.parametrize("impl", ["jnp", "interp"])
@pytest.mark.parametrize("vm", [False, True], ids=["uniform", "vm"])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m,d,g", SHAPES)
def test_fused_forward_matches_reference(m, d, g, bits, vm, impl):
    x, w, _ = _inputs(m, d)
    lv = _levels(vm, g, bits)
    y, packed, zero, rng = t_ops.matmul_quantize_packed(
        torch.from_numpy(x), torch.from_numpy(w), bits, 77, lv, group_size=g)
    jy, jp, jz, jr = j_ops.matmul_quantize_packed(
        jnp.asarray(x), jnp.asarray(w), bits, 77, lv, impl=impl, group_size=g)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jp).view(np.int32))
    np.testing.assert_array_equal(zero.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(rng.numpy(), np.asarray(jr))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    # the same words as the unfused quantizer on the same x
    for a, b in zip((packed, zero, rng), t_ref.quantize_packed(
            torch.from_numpy(x).reshape(-1, g), bits, 77, lv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["jnp", "interp"])
@pytest.mark.parametrize("vm", [False, True], ids=["uniform", "vm"])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("m,d,g", SHAPES)
def test_fused_backward_matches_reference(m, d, g, bits, vm, impl):
    x, _, gr = _inputs(m, d)
    lv = _levels(vm, g, bits)
    jp, jz, jr = j_ops.quantize_packed(jnp.asarray(x).reshape(-1, g), bits,
                                       5, lv, impl="jnp")
    dw = t_ops.dequant_matmul_packed(
        torch.from_numpy(np.array(jp).view(np.int32)),
        torch.from_numpy(np.array(jz)), torch.from_numpy(np.array(jr)),
        torch.from_numpy(gr), bits, g, d, lv)
    want = j_ops.dequant_matmul_packed(jp, jz, jr, jnp.asarray(gr), bits, g,
                                       d, lv, impl=impl)
    assert dw.shape == (d, N_OUT)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("vm", [False, True], ids=["uniform", "vm"])
@pytest.mark.parametrize("m,d,g", SHAPES + [(300, 256, 256)])
def test_orchestrators_fused_on_match_reference(m, d, g, vm):
    """compress_matmul / decompress_matmul with fused="on" at rp_ratio 0:
    the reference's words, zero, range and ``nbytes``; ``y`` and ``dw`` at
    float tolerance; and the words the unfused spelling writes."""
    x, w, gr = _inputs(m, d)
    jcfg = j_comp.CompressionConfig(2, g, 0, vm=vm)
    tcfg = t_comp.CompressionConfig(2, g, 0, vm=vm)
    jy, jct = j_comp.compress_matmul(jnp.asarray(x), jnp.asarray(w), jcfg,
                                     1234, impl="jnp", fused="on")
    y, ct = t_comp.compress_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   tcfg, 1234, fused="on")
    np.testing.assert_array_equal(ct.packed.numpy(),
                                  np.asarray(jct.packed).view(np.int32))
    np.testing.assert_array_equal(ct.zero.numpy(), np.asarray(jct.zero))
    np.testing.assert_array_equal(ct.rng.numpy(), np.asarray(jct.rng))
    assert ct.seed == int(jct.rp_seed) and ct.shape == (m, d)
    assert ct.nbytes == jct.nbytes
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    unfused = t_comp.compress(torch.from_numpy(x), tcfg, 1234)
    assert torch.equal(ct.packed, unfused.packed)
    assert ct.nbytes == unfused.nbytes
    dw = t_comp.decompress_matmul(ct, torch.from_numpy(gr), fused="on")
    jdw = j_comp.decompress_matmul(jct, jnp.asarray(gr), impl="jnp",
                                   fused="on")
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(dw, t_comp.decompress_matmul(ct, torch.from_numpy(gr),
                                                    fused="off"))


ROUTE_LEVELS = [None, (0.0, 1.1, 1.9, 3.0), tuple(float(i) for i in range(16)),
                tuple(float(i) for i in range(17))]
ROUTE_SHAPES = [(64, 256), (100, 256), (33, 256), (678, 128), (677, 128),
                (4, 96), (3, 4, 64), (677, 2048), (99, 96), (98, 96)]


@pytest.mark.parametrize("rp_ratio", [0, 1, 2, 8])
@pytest.mark.parametrize("levels", ROUTE_LEVELS,
                         ids=["uniform", "vm4", "vm16", "vm17"])
@pytest.mark.parametrize("bits,g", [(2, 256), (4, 64), (2, 1024), (2, 288)])
def test_route_fused_matches_reference(bits, g, levels, rp_ratio):
    """On a CUDA device (named by string, no card needed) "auto" gives
    "cuda" exactly where the reference's predicate and rp rule let its
    kernel impl fuse; on the CPU "auto" declines and "on" gives "torch"."""
    for shape in ROUTE_SHAPES:
        want = j_backend.route_fused("auto", "pallas", shape, bits, g,
                                     levels, rp_ratio)
        assert t_backend.route_fused("auto", "auto", shape, bits, g, levels,
                                     rp_ratio, "cuda") == (
                                         "cuda" if want else None)
        assert t_backend.route_fused("auto", "auto", shape, bits, g, levels,
                                     rp_ratio, "cpu") is None
        if want:
            assert t_backend.route_fused("on", "auto", shape, bits, g,
                                         levels, rp_ratio, "cpu") == "torch"
            assert t_backend.route_fused("on", "torch", shape, bits, g,
                                         levels, rp_ratio, "cuda") == "torch"
        else:
            with pytest.raises(ValueError):
                j_backend.route_fused("on", "jnp", shape, bits, g, levels,
                                      rp_ratio)
            for device in ("cpu", "cuda"):
                with pytest.raises(ValueError):
                    t_backend.route_fused("on", "auto", shape, bits, g,
                                          levels, rp_ratio, device)
    with pytest.raises(ValueError):
        t_backend.route_fused("auto", "cuda", (64, 256), bits, g, levels,
                              rp_ratio, "cpu")


@pytest.mark.parametrize("m,d,n", [(169_343, 512, 256), (169_343, 256, 256),
                                   (169_343, 512, 40), (677, 128, 64),
                                   (9, 64, 48), (1, 8, 8)])
def test_backward_splits_are_whole_steps_covering_rows(m, d, n):
    s, rows = t_fk.splits(m, d, n)
    assert 1 <= s <= t_fk.MAX_SPLITS and rows % t_fk.tile(n)[2] == 0
    assert (s - 1) * rows < m <= s * rows
    assert t_fk.splits(m, d, n) == (s, rows)
    assert t_fk.scratch_nbytes(m, d, n) == (4 * s * d * n if s > 1 else 0)


@pytest.mark.parametrize("d,n,limit", [(256, 256, 8_388_608),
                                       (512, 256, 8_388_608),
                                       (512, 40, 5_242_880)])
def test_backward_scratch_no_larger_at_the_slice_shapes(d, n, limit):
    """At the rp_ratio-0 slice's layers (169,343 rows) the backward's
    partials take no more device memory than the 64 x 64 SIMT tiles' did."""
    assert 0 < t_fk.scratch_nbytes(169_343, d, n) <= limit


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """A changed header rebuilds every source that includes it, and only
    those: the SR rounding (quant_common.cuh) and the tensor-core and
    async-copy helpers (tensor_core.cuh)."""
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    for name, users in (("quant_common.cuh", {"quant_blockwise",
                                              "fused_matmul"}),
                        ("tensor_core.cuh", {"rp_matmul", "fused_matmul",
                                             "flash_attention"})):
        before = {n: build.lib_path(n) for n in build.SOURCES}
        header = tmp_path / name
        header.write_text(header.read_text() + "\n// changed\n")
        after = {n: build.lib_path(n) for n in build.SOURCES}
        assert {n for n in build.SOURCES if after[n] != before[n]} == users


def test_build_digest_covers_defines():
    """A measurement build (extra -D flags) gets a library of its own; the
    plain build's name does not change with it."""
    plain = build.lib_path("fused_matmul")
    part = build.lib_path("fused_matmul", ("-DMATMUL_QUANT_PART=1",))
    assert part != plain and part.parent == plain.parent
    assert build.lib_path("fused_matmul", ()) == plain
    assert build.lib_path("fused_matmul", ("-DMATMUL_QUANT_PART=1",)) == part


# ----------------------------------------------- the slice, at small size
ARCHS = ["sage", "gcn"]
G_SMALL = 64   # divides every layer width: SAGE 256/128/128, GCN 128/64/64


@functools.lru_cache(maxsize=None)
def _graphs():
    return j_arxiv_like(scale=0.004), t_arxiv_like(scale=0.004)


def _cfgs(arch):
    return (JCfg(arch=arch, hidden=(64, 64), n_classes=40,
                 compression=j_comp.CompressionConfig(2, G_SMALL, 0,
                                                      vm=True)),
            TCfg(arch=arch, hidden=(64, 64), n_classes=40,
                 compression=t_comp.CompressionConfig(2, G_SMALL, 0,
                                                      vm=True)))


def _carried(jcfg, tcfg, in_dim):
    jp = init_gnn_params(jax.random.PRNGKey(0), jcfg, in_dim)
    return jp, params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jp], tcfg,
        device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_training_matches_reference(arch):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    _, model = _carried(jcfg, tcfg, tg.n_feats)
    rj = j_train_gnn(jg, jcfg, n_epochs=3, seed=0, verbose=True,
                     eval_every=1, impl="jnp", fused="on")
    rt = t_train_gnn(tg, tcfg, n_epochs=3, seed=0, params=model,
                     fused="on", device="cpu")
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-3)
    ledger = [r["compressed_bytes"] for r in
              t_analysis.saved_bytes_per_layer(tcfg, tg.n_feats, tg.n_nodes)]
    assert rt["stash_bytes"] == ledger


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_on_and_off_bit_identical(arch):
    """On the CPU the fused pair is the plain composition, which is the
    unfused math: the same history and weights, bit for bit."""
    _, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    _, model = _carried(jcfg, tcfg, tg.n_feats)
    runs = {f: t_train_gnn(tg, tcfg, n_epochs=3, seed=0, params=model,
                           fused=f, device="cpu") for f in ("on", "off")}
    assert [h[1] for h in runs["on"]["history"]] == \
        [h[1] for h in runs["off"]["history"]]
    for p, q in zip(runs["on"]["model"].parameters(),
                    runs["off"]["model"].parameters()):
        assert torch.equal(p, q)
    assert runs["on"]["stash_bytes"] == runs["off"]["stash_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_layer0_stash_words_bit_equal(arch):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(arch)
    jp, model = _carried(jcfg, tcfg, tg.n_feats)
    sr = int(j_seeds.sr_seed(0))
    logits = stash_gnn_forward(model, device_graph(tg, arch, "cpu"), tcfg, sr,
                               fused="on")
    ct = logits.grad_fn.stash[0]["ct"]
    feats, src, dst, _, mean_w = graph_tuple(jg)
    x = (jnp.concatenate([feats, spmm(feats, src, dst, mean_w, tg.n_nodes)],
                         axis=1) if arch == "sage" else feats)
    _, jct = j_comp.compress_matmul(x, jp[0]["w"], jcfg.compression,
                                    j_seeds.layer_seed(sr, 0), impl="jnp",
                                    fused="on")
    np.testing.assert_array_equal(ct.packed.numpy(),
                                  np.asarray(jct.packed).view(np.int32))
    assert ct.nbytes == jct.nbytes


def test_fused_on_raises_on_an_ineligible_layer():
    """fused="on" with RP (or a layer whose blocks straddle rows) raises,
    as the reference does; "auto" on the CPU trains the two-pass way."""
    _, tg = _graphs()
    tcfg = TCfg(arch="sage", hidden=(64, 64), n_classes=40,
                compression=t_comp.CompressionConfig(2, 256, 8, vm=True))
    with pytest.raises(ValueError, match="rp_ratio"):
        t_train_gnn(tg, tcfg, n_epochs=1, fused="on", device="cpu")
    with pytest.raises(ValueError, match="fused"):
        t_train_gnn(tg, tcfg, n_epochs=1, fused="sometimes", device="cpu")


def test_fused_wrappers_take_cpu_tensors_to_plain_versions():
    x, w, gr = _inputs(96, 64)
    before = (t_fk.matmul_quant.launches, t_fk.dequant_matmul.launches)
    got = t_fk.matmul_quant(torch.from_numpy(x), torch.from_numpy(w), 2, 3,
                            group_size=64)
    want = t_ref.matmul_quantize_packed(torch.from_numpy(x),
                                        torch.from_numpy(w), 2, 3,
                                        group_size=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dw = t_fk.dequant_matmul(*got[1:], torch.from_numpy(gr), 2, 64, 64)
    assert torch.equal(dw, t_ref.dequant_matmul_packed(
        *want[1:], torch.from_numpy(gr), 2, 64, 64))
    assert (t_fk.matmul_quant.launches, t_fk.dequant_matmul.launches) == \
        before
    with pytest.raises(ValueError):
        t_ops.matmul_quantize_packed(torch.from_numpy(x),
                                     torch.from_numpy(w), 2, 3,
                                     group_size=64, impl="cuda")

