"""Synthetic graph datasets with OGB-Arxiv / Cora matched statistics.

The same numpy draws as the reference's ``repro.graph.data``, in the same
order (the per-edge rewiring loop included: its draw order defines the
datasets' bits), so the port builds the same graph from the same seed.
Arrays are held as CPU tensors; :func:`repro_torch.graph.models.device_graph`
moves a graph to the device it trains on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    name: str
    features: torch.Tensor       # (N, F) f32
    labels: torch.Tensor         # (N,) int64
    edge_src: torch.Tensor       # (E,) int64, self loops, directed both ways
    edge_dst: torch.Tensor       # (E,) int64
    gcn_weight: torch.Tensor     # (E,) f32, D^-1/2 (A+I) D^-1/2 entries
    mean_weight: torch.Tensor    # (E,) f32, row-mean aggregation weights
    train_mask: torch.Tensor     # (N,) bool
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    num_classes: int

    @property
    def n_nodes(self) -> int:
        return int(self.features.shape[0])

    @property
    def n_feats(self) -> int:
        return int(self.features.shape[1])

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])


def synthetic_graph(name: str, n_nodes: int, n_edges: int, n_feats: int,
                    n_classes: int, homophily: float = 0.65,
                    feature_noise: float = 1.0, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)

    # power-law-ish degree skew: dst index drawn as floor(N * u^2)
    src = rng.integers(0, n_nodes, n_edges)
    dst = (n_nodes * rng.random(n_edges) ** 2).astype(np.int64)
    # homophily: rewire a fraction of edges to a same-class destination
    same = rng.random(n_edges) < homophily
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    rewired = np.array(
        [by_class[labels[s]][rng.integers(len(by_class[labels[s]]))]
         if m else d for s, d, m in zip(src, dst, same)], dtype=np.int64)
    dst = rewired
    keep = src != dst
    src, dst = src[keep], dst[keep]

    # symmetrize + self loops
    s_all = np.concatenate([src, dst, np.arange(n_nodes)])
    d_all = np.concatenate([dst, src, np.arange(n_nodes)])

    deg = np.bincount(d_all, minlength=n_nodes).astype(np.float64)
    gcn_w = 1.0 / np.sqrt(deg[s_all] * deg[d_all])
    mean_w = 1.0 / deg[d_all]

    centers = rng.normal(0, 1, (n_classes, n_feats))
    feats = centers[labels] + feature_noise * rng.normal(0, 1, (n_nodes, n_feats))

    perm = rng.permutation(n_nodes)
    n_tr, n_va = int(0.6 * n_nodes), int(0.2 * n_nodes)
    train_mask = np.zeros(n_nodes, bool)
    val_mask = np.zeros(n_nodes, bool)
    test_mask = np.zeros(n_nodes, bool)
    train_mask[perm[:n_tr]] = True
    val_mask[perm[n_tr:n_tr + n_va]] = True
    test_mask[perm[n_tr + n_va:]] = True

    return Graph(
        name=name,
        features=torch.from_numpy(feats.astype(np.float32)),
        labels=torch.from_numpy(labels.astype(np.int64)),
        edge_src=torch.from_numpy(s_all.astype(np.int64)),
        edge_dst=torch.from_numpy(d_all.astype(np.int64)),
        gcn_weight=torch.from_numpy(gcn_w.astype(np.float32)),
        mean_weight=torch.from_numpy(mean_w.astype(np.float32)),
        train_mask=torch.from_numpy(train_mask),
        val_mask=torch.from_numpy(val_mask),
        test_mask=torch.from_numpy(test_mask),
        num_classes=n_classes,
    )


def arxiv_like(scale: float = 0.1, seed: int = 0) -> Graph:
    """OGB-Arxiv stand-in: 169,343 nodes / ~1.17M edges / 128 feats / 40 cls."""
    n = max(512, int(169_343 * scale))
    e = max(4 * n, int(1_166_243 * scale))
    return synthetic_graph("arxiv-like", n, e, 128, 40, homophily=0.5,
                           feature_noise=2.0, seed=seed)


def cora_like(scale: float = 1.0, seed: int = 0) -> Graph:
    """Cora stand-in: 2,708 nodes / ~10.5K edges / 128 feats / 7 classes."""
    n = max(256, int(2_708 * scale))
    e = max(4 * n, int(10_556 * scale))
    return synthetic_graph("cora-like", n, e, 128, 7, homophily=0.6,
                           feature_noise=1.5, seed=seed)
