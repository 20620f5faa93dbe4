"""Synthetic graph datasets with OGB-Arxiv / Flickr / Cora matched
statistics.

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


def in_adjacency(edge_src, edge_dst, n_nodes: int):
    """CSR over *destination*: ``(nbr, starts)`` with the in-neighbors
    (message sources) of node ``u`` at ``nbr[starts[u]:starts[u+1]]``, as
    numpy arrays (a helper for partitioners and samplers; training reads
    the edge list through :func:`repro_torch.graph.models.device_graph`)."""
    src = np.asarray(edge_src)
    dst = np.asarray(edge_dst)
    order = np.argsort(dst, kind="stable")
    starts = np.searchsorted(dst[order], np.arange(n_nodes + 1))
    return src[order], starts


def _split_masks(rng: np.random.Generator, n_nodes: int):
    perm = rng.permutation(n_nodes)
    n_tr, n_va = int(0.6 * n_nodes), int(0.2 * n_nodes)
    masks = [np.zeros(n_nodes, bool) for _ in range(3)]
    masks[0][perm[:n_tr]] = True
    masks[1][perm[n_tr:n_tr + n_va]] = True
    masks[2][perm[n_tr + n_va:]] = True
    return masks


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

    train_mask, val_mask, test_mask = _split_masks(rng, n_nodes)

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


def stream_edge_chunks(n_nodes: int, n_edges: int, *, labels=None,
                       homophily: float = 0.0, seed: int = 0,
                       chunk_edges: int = 1 << 18):
    """Yield the synthetic edge stream as ``(src, dst)`` numpy chunks with
    O(chunk) host memory: :func:`synthetic_graph`'s family (uniform
    sources, ``floor(N u^2)`` destinations, a ``homophily`` fraction
    rewired to a same-class node through one ``argsort(labels)`` table),
    vectorized a chunk at a time.  Self loops are dropped per chunk, so
    chunk lengths vary; the drawn count is exact."""
    rng = np.random.default_rng(seed)
    order = starts = None
    if homophily > 0.0:
        if labels is None:
            raise ValueError("homophily > 0 needs labels")
        labels = np.asarray(labels)
        order = np.argsort(labels, kind="stable")
        n_classes = int(labels.max()) + 1
        starts = np.searchsorted(labels[order], np.arange(n_classes + 1))
    done = 0
    while done < n_edges:
        k = min(chunk_edges, n_edges - done)
        src = rng.integers(0, n_nodes, k)
        dst = (n_nodes * rng.random(k) ** 2).astype(np.int64)
        if homophily > 0.0:
            rew = rng.random(k) < homophily
            ls = labels[src[rew]]
            lo, hi = starts[ls], starts[ls + 1]
            dst[rew] = order[lo + rng.integers(0, hi - lo)]
        keep = src != dst
        yield src[keep], dst[keep]
        done += k


def synthetic_graph_streamed(name: str, n_nodes: int, n_edges: int,
                             n_feats: int, n_classes: int,
                             homophily: float = 0.0,
                             feature_noise: float = 1.0, seed: int = 0,
                             chunk_edges: int = 1 << 18) -> Graph:
    """:func:`synthetic_graph`'s pipeline (symmetrize, self loops, GCN and
    mean weights, class-centred features, 60/20/20 split) over
    :func:`stream_edge_chunks`, degrees accumulated a chunk at a time.  Its
    draws differ from :func:`synthetic_graph`'s, so the two give different
    graphs from one seed."""
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, n_classes, n_nodes)
    deg = np.ones(n_nodes, np.int64)            # self loops
    srcs, dsts = [np.arange(n_nodes)], [np.arange(n_nodes)]
    for src, dst in stream_edge_chunks(n_nodes, n_edges, labels=labels,
                                       homophily=homophily, seed=seed,
                                       chunk_edges=chunk_edges):
        srcs.extend([src, dst])
        dsts.extend([dst, src])
        deg += np.bincount(dst, minlength=n_nodes)
        deg += np.bincount(src, minlength=n_nodes)
    s_all = np.concatenate(srcs)
    d_all = np.concatenate(dsts)
    degf = deg.astype(np.float64)
    gcn_w = 1.0 / np.sqrt(degf[s_all] * degf[d_all])
    mean_w = 1.0 / degf[d_all]

    centers = rng.normal(0, 1, (n_classes, n_feats))
    feats = (centers[labels]
             + feature_noise * rng.normal(0, 1, (n_nodes, n_feats)))
    train_mask, val_mask, test_mask = _split_masks(rng, n_nodes)
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


def papers100m_like(scale: float = 1e-4, seed: int = 0) -> Graph:
    """ogbn-papers100M stand-in: 111,059,956 nodes / 1.6B edges / 128
    feats / 172 classes, scaled down by ``scale`` and built through
    :func:`synthetic_graph_streamed`."""
    n = max(4096, int(111_059_956 * scale))
    e = max(8 * n, int(1_615_685_872 * scale))
    return synthetic_graph_streamed("papers100m-like", n, e, 128, 172,
                                    homophily=0.4, feature_noise=2.5,
                                    seed=seed)


def arxiv_like(scale: float = 0.1, seed: int = 0) -> Graph:
    """OGB-Arxiv stand-in: 169,343 nodes / ~1.17M edges / 128 feats / 40 cls."""
    n = max(512, int(169_343 * scale))
    e = max(4 * n, int(1_166_243 * scale))
    return synthetic_graph("arxiv-like", n, e, 128, 40, homophily=0.5,
                           feature_noise=2.0, seed=seed)


def flickr_like(scale: float = 0.1, seed: int = 0) -> Graph:
    """Flickr stand-in: 89,250 nodes / ~900K edges / 500 feats / 7 classes
    (the paper's Table 1 second dataset; a hard task, tuned toward its
    ~51.8 % FP32 operating point)."""
    n = max(512, int(89_250 * scale))
    e = max(4 * n, int(899_756 * scale))
    return synthetic_graph("flickr-like", n, e, 500, 7, homophily=0.4,
                           feature_noise=3.0, seed=seed)


def cora_like(scale: float = 1.0, seed: int = 0) -> Graph:
    """Cora stand-in: 2,708 nodes / ~10.5K edges / 128 feats / 7 classes."""
    n = max(256, int(2_708 * scale))
    e = max(4 * n, int(10_556 * scale))
    return synthetic_graph("cora-like", n, e, 128, 7, homophily=0.6,
                           feature_noise=1.5, seed=seed)
