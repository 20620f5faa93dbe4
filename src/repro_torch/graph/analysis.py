"""The paper's analyses (the reference's ``repro.graph.analysis``): the
Table-1 memory model, pure arithmetic equal to the reference's numbers; the
bytes a training step's stash holds (equal to the model's for a compressed
layer; an uncompressed layer holds a packed 1-bit ReLU mask where the model
counts an f32 ReLU context); the per-layer statistics
autoprec allocates from; the measured-against-Eq. 10 variance report of
the quant-health probe; and the Table-2 / App. D activation-distribution
instrumentation."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend
from repro_torch.core import pack as packmod
from repro_torch.core import quant as quantmod
from repro_torch.core.autoprec import LayerStats
from repro_torch.core.compressor import RP_SEED_SALT
from repro_torch.core.variance import (js_divergence, model_histogram,
                                       optimize_levels)
from repro_torch.engine.seeds import layer_seed
from repro_torch.graph.models import GNN, DeviceGraph, GNNConfig, _dims, spmm


def relu_mask_nbytes(n_elements: int) -> int:
    """Bytes of the packed 1-bit ReLU sign mask (whole 32-bit words)."""
    return 4 * ((n_elements + 31) // 32)


def saved_bytes_per_layer(cfg: GNNConfig, in_dim: int,
                          n_nodes: int) -> list[dict]:
    """Per-layer saved-for-backward bytes.  ``fp32_bytes``: the f32 linear
    input plus (hidden layers) the f32 ReLU context; ``compressed_bytes``
    (compressed layers only): packed post-RP code words + 8-byte per-block
    (zero, range) + the 4-byte RP seed + the word-aligned 1-bit ReLU mask;
    ``bits``: the layer's quantization width."""
    dims = _dims(cfg, in_dim)
    per_layer = cfg.layer_compression()
    rows = []
    for li, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        lin_in = d_in * (2 if cfg.arch == "sage" else 1)
        hidden = li < len(dims) - 2
        fp32 = n_nodes * lin_in * 4 + (n_nodes * d_out * 4 if hidden else 0)
        row = {"layer": li, "fp32_bytes": fp32}
        comp = per_layer[li]
        if comp is not None:
            d_eff = lin_in // comp.rp_ratio if comp.rp_ratio > 1 else lin_in
            c = packmod.packed_nbytes((n_nodes, d_eff), comp.bits,
                                      comp.group_size) + 4
            if hidden:
                c += relu_mask_nbytes(n_nodes * d_out)
            row["compressed_bytes"] = c
            row["bits"] = comp.bits
        rows.append(row)
    return rows


def live_stash_bytes(cfg: GNNConfig, in_dim: int, n_nodes: int) -> list[int]:
    """Bytes a full-graph training step's stash holds per layer
    (``engine.forward.stash_nbytes``): a compressed layer's
    ``compressed_bytes``; an uncompressed layer's f32 linear input plus, on
    a hidden layer, the packed 1-bit ReLU mask (``fp32_bytes`` counts an f32
    ReLU context there instead)."""
    dims = _dims(cfg, in_dim)
    out = []
    for row in saved_bytes_per_layer(cfg, in_dim, n_nodes):
        li = row["layer"]
        n = row.get("compressed_bytes")
        if n is None:
            lin_in = dims[li] * (2 if cfg.arch == "sage" else 1)
            n = n_nodes * lin_in * 4
            if li < len(dims) - 2:
                n += relu_mask_nbytes(n_nodes * dims[li + 1])
        out.append(n)
    return out


@torch.no_grad()
def _iter_layer_inputs(model: GNN, graph: DeviceGraph, cfg: GNNConfig):
    """Yield ``(li, x)`` where ``x`` is the linear input layer ``li``
    stashes: the one traversal every collector shares, mirroring
    :meth:`repro_torch.graph.models.GNN.forward` (arch dispatch, SAGE
    concat, the aggregation, interior ReLU), so the collectors cannot drift
    from what training saves."""
    h = graph.features
    n_layers = len(model.weights)
    for li, (w, b) in enumerate(zip(model.weights, model.biases)):
        x = h if cfg.arch == "gcn" else torch.cat(
            [h, spmm(h, graph.adj.fwd)], dim=1)
        yield li, x
        z = x @ w + b
        if cfg.arch == "gcn":
            z = spmm(z, graph.adj.fwd)
        h = torch.relu(z) if li < n_layers - 1 else z


def collect_layer_stats(model: GNN, graph: DeviceGraph, cfg: GNNConfig,
                        seed: int = 0) -> list[LayerStats | None]:
    """One forward pass collecting autoprec's per-layer sensitivities.

    For every compressed layer this captures what the stash would quantize
    (the linear input, projected at the layer's own ``rp_ratio`` with the
    compressor's RP seed, ``layer_seed(seed, li) ^ 0xA5A5A5A5``, through the
    RP kernel on the card) regrouped into the layer's blocks, and
    summarizes it as a :class:`repro_torch.core.autoprec.LayerStats`
    (stash shape, block count, E[range²]).  Uncompressed layers yield
    ``None``.  Moments only: no quantization, no gradients."""
    per_layer = cfg.layer_compression()
    stats: list[LayerStats | None] = []
    for li, x in _iter_layer_inputs(model, graph, cfg):
        comp = per_layer[li]
        if comp is None:
            stats.append(None)
            continue
        xs = x
        if comp.rp_ratio > 1:
            rp_seed = layer_seed(seed, li) ^ RP_SEED_SALT
            xs = backend.rp(x, rp_seed, max(1, x.shape[1] // comp.rp_ratio),
                            impl=comp.impl)
        blocks, _ = quantmod.group_reshape(xs, comp.group_size)
        _, rng = quantmod.block_stats(blocks)
        stats.append(LayerStats(
            shape=tuple(int(s) for s in xs.shape),
            n_blocks=int(blocks.shape[0]),
            rng_sq_mean=float(torch.mean(rng.to(torch.float32) ** 2))))
    return stats


def variance_validation_report(model: GNN, graph: DeviceGraph,
                               cfg: GNNConfig, seed: int = 0) -> list[dict]:
    """Measured SR dequantization variance against the Eq. 10 prediction,
    one row per compressed layer.

    Runs the quant-health probe (:mod:`repro_torch.obs.quantstats`) on
    ``model``: the quantize and dequantize the training stash performs,
    through the same kernels and the same per-layer seeds, and prices each
    layer through :func:`repro_torch.core.autoprec.expected_layer_variance`.
    Rows carry ``measured_var``, ``predicted_var``, ``ratio`` and
    ``sat_rate``; a ratio far from 1 on a real layer means the variance
    model autoprec prices with has drifted from what the quantizer does."""
    # obs.quantstats reaches back into this module for _iter_layer_inputs:
    # import at call time, not at module load
    from repro_torch.obs.quantstats import health_rows, measure_quant_health

    measured = measure_quant_health(model, graph, cfg, seed=seed)
    return health_rows(measured, cfg.layer_compression())


def collect_projected_activations(model: GNN, graph: DeviceGraph,
                                  cfg: GNNConfig, rp_ratio: int = 8,
                                  seed: int = 0, bits: int = 2
                                  ) -> list[np.ndarray]:
    """Each layer's normalized projected activation H̄_proj (paper App. D:
    after RP with seed ``seed + li``, before quantization, normalized per
    row to [0, B] with B = 2**bits - 1), as numpy arrays."""
    B = float(2**bits - 1)
    captured = []
    for li, x in _iter_layer_inputs(model, graph, cfg):
        proj = backend.rp(x, seed + li, max(1, x.shape[1] // rp_ratio))
        zero = proj.amin(dim=1, keepdim=True)
        rng = torch.clamp_min(proj.amax(dim=1, keepdim=True) - zero,
                              quantmod.EPS)
        captured.append(((proj - zero) / rng * B).cpu().numpy())
    return captured


def table2_row(hbar: np.ndarray, bits: int = 2, n_bins: int = 60) -> dict:
    """JS(uniform), JS(clipped-normal) and the empirical VM variance
    reduction (paper Table 2, Eq. 19) of one layer's H̄_proj."""
    R = hbar.shape[1]
    B = 2**bits - 1
    edges = np.linspace(0, B, n_bins + 1)
    obs, _ = np.histogram(hbar.reshape(-1), bins=edges)
    obs = obs / obs.sum()
    js_u = js_divergence(obs, model_histogram(R, bits, edges, "uniform"))
    js_cn = js_divergence(obs, model_histogram(R, bits, edges, "clipnorm"))

    # Eq. 19: Var.Red = 1 - sum (h - SR*(h))^2 / sum (h - SR(h))^2
    h = torch.tensor(np.asarray(hbar, np.float32))
    lv_u = quantmod.uniform_levels(bits)
    lv_o = torch.tensor(optimize_levels(R, bits), dtype=torch.float32)
    err_u, err_o, n_rep = 0.0, 0.0, 4
    for s in range(n_rep):
        cu = quantmod.stochastic_round_to_levels(h, lv_u, s)
        co = quantmod.stochastic_round_to_levels(h, lv_o, s + 101)
        du = lv_u[cu.to(torch.int64)]
        do = lv_o[co.to(torch.int64)]
        err_u += float(torch.sum((h - du) ** 2))
        err_o += float(torch.sum((h - do) ** 2))
    return {
        "R": R,
        "js_uniform": float(js_u),
        "js_clipnorm": float(js_cn),
        "var_reduction_pct": 100.0 * (1.0 - err_o / max(err_u, 1e-30)),
    }
