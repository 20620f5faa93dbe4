"""The benchmark's graph generator: a frozen copy of the port's synthetic
datasets (``repro_torch.graph.data.synthetic_graph``), kept here so that a
later change to the program cannot change the inputs it is measured on.

The draws are the port's, in the port's order, so the same seed gives the
same graph bit for bit.  The one change is speed: the port rewires each
edge in a Python loop with one ``rng.integers(n)`` call an edge; here one
call draws them all.  numpy's bounded integers draw each element of an
array of bounds exactly as a scalar call with that bound would (Lemire's
method on the bit generator's 32-bit stream, nothing drawn for a bound of
1), so the stream and the graph are the same.  A CPU test holds this copy
equal to the port's generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostGraph:
    """A graph as numpy arrays on the host: what both the program and the
    plain reference are handed."""

    name: str
    features: np.ndarray      # (N, F) f32
    labels: np.ndarray        # (N,) int64
    edge_src: np.ndarray      # (E,) int64: self loops, both directions
    edge_dst: np.ndarray      # (E,) int64
    gcn_weight: np.ndarray    # (E,) f32
    mean_weight: np.ndarray   # (E,) f32: 1 / in-degree of the destination
    train_mask: np.ndarray    # (N,) bool
    val_mask: np.ndarray
    test_mask: np.ndarray
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


def _split_masks(rng: np.random.Generator, n_nodes: int):
    perm = rng.permutation(n_nodes)
    n_tr, n_va = int(0.6 * n_nodes), int(0.2 * n_nodes)
    masks = [np.zeros(n_nodes, bool) for _ in range(3)]
    masks[0][perm[:n_tr]] = True
    masks[1][perm[n_tr:n_tr + n_va]] = True
    masks[2][perm[n_tr + n_va:]] = True
    return masks


def synthetic_graph(name: str, n_nodes: int, n_edges: int, n_feats: int,
                    n_classes: int, homophily: float, feature_noise: float,
                    seed: int) -> HostGraph:
    """Power-law destinations (``floor(N u^2)``), a ``homophily`` share of
    edges rewired to a node of the source's class, symmetrized with self
    loops; features are class centres plus Gaussian noise; a 60/20/20
    split."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    src = rng.integers(0, n_nodes, n_edges)
    dst = (n_nodes * rng.random(n_edges) ** 2).astype(np.int64)
    same = rng.random(n_edges) < homophily
    # the class members in index order, as the port's per-class lists
    by_class = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[by_class], np.arange(n_classes + 1))
    cls = labels[src[same]]
    pick = rng.integers(starts[cls + 1] - starts[cls])
    dst = dst.copy()
    dst[same] = by_class[starts[cls] + pick]
    keep = src != dst
    src, dst = src[keep], dst[keep]

    s_all = np.concatenate([src, dst, np.arange(n_nodes)])
    d_all = np.concatenate([dst, src, np.arange(n_nodes)])
    deg = np.bincount(d_all, minlength=n_nodes).astype(np.float64)
    gcn_w = 1.0 / np.sqrt(deg[s_all] * deg[d_all])
    mean_w = 1.0 / deg[d_all]

    centers = rng.normal(0, 1, (n_classes, n_feats))
    feats = centers[labels] + feature_noise * rng.normal(0, 1, (n_nodes,
                                                                n_feats))
    train_mask, val_mask, test_mask = _split_masks(rng, n_nodes)
    return HostGraph(
        name=name, features=feats.astype(np.float32),
        labels=labels.astype(np.int64), edge_src=s_all.astype(np.int64),
        edge_dst=d_all.astype(np.int64), gcn_weight=gcn_w.astype(np.float32),
        mean_weight=mean_w.astype(np.float32), train_mask=train_mask,
        val_mask=val_mask, test_mask=test_mask, num_classes=n_classes)


def make_graph(spec: dict, seed: int) -> HostGraph:
    """The graph a configuration's ``graph`` section names, from ``seed``."""
    return synthetic_graph(spec["name"], int(spec["n_nodes"]),
                           int(spec["n_edges"]), int(spec["n_feats"]),
                           int(spec["n_classes"]), float(spec["homophily"]),
                           float(spec["feature_noise"]), seed)
