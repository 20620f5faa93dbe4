"""Cluster-GCN-style partition sampling: node partitions into padded
subgraph batches of one shape (the reference's ``repro.graph.sampling``,
the same numpy, so the port cuts the same batches from the same seed).

Full-graph training keeps every layer's stash for all N nodes at once;
block-wise compression shrinks those bytes but not the O(N) live set.
Mini-batch training does: partition the nodes (balanced random, or greedy
multi-source BFS for locality), train on one intra-partition subgraph at a
time, and only that partition's stash is ever live.

Every batch of a call is padded to the same node and edge counts (the
largest partition's, rounded up to a bucket multiple), so each batch's
stash has the same layout and the byte ledger of one padded batch is the
peak.  Padding is inert: pad feature rows are zero, pad edges carry weight
0 and point at node 0, pad rows are in no loss or metric mask, and the
engine pins pad rows to zero after every layer and at the top of every
backward layer (``node_mask``).

``halo=k`` adds each partition's k-hop in-neighbourhood (Cluster-GCN's
boundary edges): halo nodes aggregate but carry no loss.

The reference stacks the batches along a leading axis and groups them into
``(updates, grad_accum, dp)`` for its ``lax.scan`` epoch (``stack_batches``,
``group_batches``).  PyTorch runs eagerly, so the port keeps the list of
batches and an order of indices per epoch instead
(:class:`repro_torch.engine.compile.CompiledPartition`).
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

from repro_torch.graph.data import Graph, in_adjacency


# ------------------------------------------------------------ partitioners
def random_partition(n_nodes: int, n_parts: int, seed: int = 0) -> np.ndarray:
    """Balanced uniform-random node partition: (N,) part ids, sizes
    differing by at most 1."""
    if not 1 <= n_parts <= n_nodes:
        raise ValueError(f"n_parts={n_parts} must be in [1, {n_nodes}]")
    rng = np.random.default_rng(seed)
    base, extra = divmod(n_nodes, n_parts)
    counts = base + (np.arange(n_parts) < extra)
    part = np.repeat(np.arange(n_parts), counts)
    rng.shuffle(part)
    return part


def bfs_partition(edge_src, edge_dst, n_nodes: int, n_parts: int,
                  seed: int = 0) -> np.ndarray:
    """Greedy multi-source BFS partition (locality without METIS).

    All parts grow at once from random seed nodes, the smallest part
    expanding next, each capped at ceil(N/P) nodes; nodes no frontier
    reaches fill the smallest parts.  On homophilous graphs most edges stay
    inside a part, which limits Cluster-GCN's gradient bias."""
    if not 1 <= n_parts <= n_nodes:
        raise ValueError(f"n_parts={n_parts} must be in [1, {n_nodes}]")
    src = np.asarray(edge_src)
    dst = np.asarray(edge_dst)
    nbr, starts = in_adjacency(src, dst, n_nodes)
    rng = np.random.default_rng(seed)
    cap = math.ceil(n_nodes / n_parts)
    part = np.full(n_nodes, -1, np.int64)
    sizes = np.zeros(n_parts, np.int64)
    seeds = rng.choice(n_nodes, n_parts, replace=False)
    queues = []
    for p, s in enumerate(seeds):
        part[s] = p
        sizes[p] = 1
        queues.append(collections.deque([int(s)]))
    active = set(range(n_parts))
    while active:
        p = min(active, key=lambda q: sizes[q])
        if not queues[p] or sizes[p] >= cap:
            active.discard(p)
            continue
        u = queues[p].popleft()
        for v in nbr[starts[u]:starts[u + 1]]:
            if part[v] < 0 and sizes[p] < cap:
                part[v] = p
                sizes[p] += 1
                queues[p].append(int(v))
    for v in np.flatnonzero(part < 0):
        p = int(np.argmin(sizes))
        part[v] = p
        sizes[p] += 1
    return part


# ------------------------------------------------------------------ batch
@dataclasses.dataclass
class SubgraphBatch:
    """One padded node-partition subgraph, as CPU tensors
    (:func:`repro_torch.graph.models.device_graph` moves it to a device).

    Local node order: owned partition nodes, then halo nodes, then zero
    padding.  ``node_mask`` marks the real (owned and halo) rows; the
    train/val/test masks cover owned rows only."""

    features: torch.Tensor      # (Np, F) f32, zero on padding rows
    labels: torch.Tensor        # (Np,) int64, 0 on padding
    edge_src: torch.Tensor      # (Ep,) int64, 0 on padding
    edge_dst: torch.Tensor      # (Ep,) int64, 0 on padding
    gcn_weight: torch.Tensor    # (Ep,) f32, 0 on padding edges
    mean_weight: torch.Tensor   # (Ep,) f32, 0 on padding edges
    train_mask: torch.Tensor    # (Np,) f32, owned nodes only
    val_mask: torch.Tensor      # (Np,) f32
    test_mask: torch.Tensor     # (Np,) f32
    node_mask: torch.Tensor     # (Np,) f32, 1 real (halo included), 0 pad
    n_real_nodes: int
    n_real_edges: int

    @property
    def n_nodes(self) -> int:
        """Padded node count."""
        return int(self.features.shape[0])

    @property
    def n_edges(self) -> int:
        """Padded edge count."""
        return int(self.edge_src.shape[0])

    def graph_tuple(self):
        """``(features, edge_src, edge_dst, gcn_weight, mean_weight)``, the
        reference's graph tuple."""
        return (self.features, self.edge_src, self.edge_dst,
                self.gcn_weight, self.mean_weight)


# ---------------------------------------------------------------- sampler
def _bucket(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def make_subgraph_batches(g: Graph, n_parts: int, *, method: str = "bfs",
                          halo: int = 0, seed: int = 0,
                          node_multiple: int = 64, edge_multiple: int = 256,
                          renormalize: bool = False) -> list[SubgraphBatch]:
    """Split ``g`` into ``n_parts`` padded subgraph batches.

    method        "bfs" (greedy multi-source BFS) or "random" (balanced
                  uniform, Cluster-GCN's stochastic baseline).
    halo          hops of in-neighbourhood context around each partition
                  (0 = intra-partition edges only).
    node/edge_multiple
                  pad buckets: every batch takes the largest real size
                  rounded up to these multiples (1 = tight padding;
                  ``n_parts=1`` with multiples of 1 is the full graph).
    renormalize   recompute the GCN / mean weights from subgraph degrees
                  (Cluster-GCN's normalization) instead of slicing the
                  full graph's; off by default, so ``n_parts=1`` is the
                  full graph bit for bit.
    """
    src = np.asarray(g.edge_src)
    dst = np.asarray(g.edge_dst)
    n = g.n_nodes
    if n_parts == 1:
        part = np.zeros(n, np.int64)
    elif method == "random":
        part = random_partition(n, n_parts, seed)
    elif method == "bfs":
        part = bfs_partition(src, dst, n, n_parts, seed)
    else:
        raise ValueError(f"unknown partition method {method!r}")

    feats = np.asarray(g.features)
    labels = np.asarray(g.labels)
    gcn_w = np.asarray(g.gcn_weight)
    mean_w = np.asarray(g.mean_weight)
    masks = {"train": np.asarray(g.train_mask), "val": np.asarray(g.val_mask),
             "test": np.asarray(g.test_mask)}

    raw = []
    for p in range(n_parts):
        owned = np.flatnonzero(part == p)
        in_set = np.zeros(n, bool)
        in_set[owned] = True
        for _ in range(halo):
            in_set[src[in_set[dst]]] = True
        halo_nodes = np.setdiff1d(np.flatnonzero(in_set), owned,
                                  assume_unique=True)
        nodes = np.concatenate([owned, halo_nodes])
        loc = np.full(n, -1, np.int64)
        loc[nodes] = np.arange(len(nodes))
        keep = in_set[src] & in_set[dst]
        s_loc, d_loc = loc[src[keep]], loc[dst[keep]]
        if renormalize:
            deg = np.bincount(d_loc, minlength=len(nodes)).astype(np.float64)
            deg = np.maximum(deg, 1.0)
            gw = 1.0 / np.sqrt(deg[s_loc] * deg[d_loc])
            mw = 1.0 / deg[d_loc]
        else:
            gw, mw = gcn_w[keep], mean_w[keep]
        raw.append((nodes, len(owned), s_loc, d_loc, gw, mw))

    n_pad = _bucket(max(len(r[0]) for r in raw), node_multiple)
    e_pad = _bucket(max(len(r[2]) for r in raw), edge_multiple)

    batches = []
    for nodes, n_owned, s_loc, d_loc, gw, mw in raw:
        nl, el = len(nodes), len(s_loc)
        f = np.zeros((n_pad, feats.shape[1]), np.float32)
        f[:nl] = feats[nodes]
        lab = np.zeros(n_pad, np.int64)
        lab[:nl] = labels[nodes]
        es = np.zeros(e_pad, np.int64)
        ed = np.zeros(e_pad, np.int64)
        ew_g = np.zeros(e_pad, np.float32)
        ew_m = np.zeros(e_pad, np.float32)
        es[:el], ed[:el] = s_loc, d_loc
        ew_g[:el], ew_m[:el] = gw, mw
        node_mask = np.zeros(n_pad, np.float32)
        node_mask[:nl] = 1.0
        owned_rows = np.arange(n_pad) < n_owned
        m = {}
        for k, full in masks.items():
            mk = np.zeros(n_pad, np.float32)
            mk[:nl] = full[nodes].astype(np.float32)
            m[k] = torch.from_numpy(mk * owned_rows)
        batches.append(SubgraphBatch(
            features=torch.from_numpy(f), labels=torch.from_numpy(lab),
            edge_src=torch.from_numpy(es), edge_dst=torch.from_numpy(ed),
            gcn_weight=torch.from_numpy(ew_g),
            mean_weight=torch.from_numpy(ew_m),
            train_mask=m["train"], val_mask=m["val"], test_mask=m["test"],
            node_mask=torch.from_numpy(node_mask),
            n_real_nodes=nl, n_real_edges=el))
    return batches
