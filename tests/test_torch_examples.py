"""The port's examples (``examples/torch_*.py``) run through their
``main`` at tiny size on the CPU, held to the reference where the two
compute the same thing: the quickstart's compressor on the same input, and
the GNN driver's M column (``activation_memory_report``)."""
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference_compressor():
    """On the same input: equal stored bytes, reconstructions within 1e-5
    (of their scale), the same VM levels and expected variances."""
    import jax.numpy as jnp

    from repro.core import (CompressionConfig, compress, decompress,
                            expected_sr_variance,
                            expected_sr_variance_uniform, optimize_levels)

    x = (np.random.default_rng(0).standard_normal((1024, 256)) * 2.0
         + 0.5).astype(np.float32)
    got = _example("quickstart").main(["--device", "cpu", "--seeds", "2"],
                                      x=torch.from_numpy(x))
    assert got["x_bytes"] == x.nbytes
    for row in got["rows"]:
        c = row["cfg"]
        ref_ct = compress(jnp.asarray(x), CompressionConfig(
            bits=c.bits, group_size=c.group_size, rp_ratio=c.rp_ratio,
            vm=c.vm), seed=0)
        assert row["stored_bytes"] == ref_ct.nbytes, row["desc"]
        # within 1e-5 of the largest |x_hat|: the inverse projection is a
        # float32 product of 32 terms summed in each library's own order
        want = np.asarray(decompress(ref_ct))
        err = np.abs(row["xhat"].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (row["desc"], err)
        assert row["err_mean"] < row["err_one_seed"]
    lv = optimize_levels(256, bits=2)
    np.testing.assert_allclose(got["levels"], lv, rtol=0, atol=1e-7)
    assert got["var_uniform"] == pytest.approx(
        expected_sr_variance_uniform(256), rel=1e-6)
    assert got["var_optimized"] == pytest.approx(
        expected_sr_variance(lv, 256), rel=1e-6)


def test_train_gnn_iexact_m_column_matches_reference():
    """Every row's M and the mini-batch peak equal the reference's
    activation_memory_report on the same graph; losses finite."""
    from repro.core import CompressionConfig as RefComp
    from repro.graph import GNNConfig as RefCfg
    from repro.graph import activation_memory_report as ref_report
    from repro.graph import arxiv_like as ref_arxiv
    from repro.graph.sampling import make_subgraph_batches as ref_batches

    got = _example("train_gnn_iexact").main(
        ["--scale", "0.004", "--epochs", "2", "--batches", "4",
         "--device", "cpu"])
    g = ref_arxiv(scale=0.004)
    assert (got["n_nodes"], got["n_feats"]) == (g.n_nodes, g.n_feats)

    def ref_cfg(cfg):
        c = cfg.compression
        comp = None if c is None else RefComp(c.bits, c.group_size,
                                              c.rp_ratio, vm=c.vm)
        return RefCfg(arch="sage", hidden=cfg.hidden,
                      n_classes=cfg.n_classes, compression=comp)

    assert len(got["rows"]) == 5
    for row in got["rows"]:
        rep = ref_report(g, ref_cfg(row["cfg"]))
        assert row["m_bytes"] == rep.get("compressed_bytes",
                                         rep["fp32_bytes"]), row["name"]
        assert all(math.isfinite(x) for x in row["losses"])
        if row["cfg"].compression is not None:
            assert sum(row["stash_bytes"]) == row["m_bytes"]
    b = got["batched"]
    assert b["batch_nodes"] == ref_batches(g, 4, seed=0)[0].n_nodes
    rep = ref_report(g, ref_cfg(b["cfg"]), n_parts=4,
                     batch_nodes=b["batch_nodes"])
    assert b["peak_bytes"] == rep["batched"]["peak_saved_bytes"]
    assert sum(b["stash_bytes"]) == b["peak_bytes"]
    assert all(math.isfinite(x) for x in b["losses"])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "seamless-m4t-large-v2"])
def test_serve_decode_finishes_finite(arch):
    got = _example("serve_decode").main(
        ["--arch", arch, "--batch", "2", "--prompt-len", "16",
         "--gen-len", "6", "--device", "cpu"])
    assert got["logits_finite"]
    assert tuple(got["tokens"].shape) == (2, 6)
    assert math.isfinite(got["tokens_per_s"])


def test_train_lm_compressed_finishes_finite():
    got = _example("train_lm_compressed").main(["--steps", "2",
                                                "--device", "cpu"])
    assert set(got) == {"remat", "act"}
    for mode, r in got.items():
        assert len(r["losses"]) == 2
        assert all(math.isfinite(x) for x in r["losses"]), mode
    assert got["act"]["stash_bytes"] < got["remat"]["stash_bytes"]
