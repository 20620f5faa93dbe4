"""Partition-parallel halo exchange over a ``torch.distributed`` process
group (the reference's ``repro.parallel.halo``).

The mesh sampling policy (``SamplingPolicy(kind="mesh")``) trains
``n_parts`` graph partitions on a group of ``m`` ranks in ``rounds =
n_parts // m`` rounds: round ``r`` hosts partitions ``[r*m, (r+1)*m)``,
partition ``r*m + i`` on rank ``i``.  Edges whose endpoints live in
different rounds are dropped (the Cluster-GCN approximation at round
granularity: ``m == n_parts`` keeps every edge and is exact distributed
full-graph training, ``m == 1`` is the mini-batch engine's per-partition
subgraphs); edges that cross partitions within a round are kept and served
by a halo exchange: before each aggregation every rank gathers the boundary
rows its round-mates need into an ``(m, H, F)`` send buffer, and one
``all_to_all_single`` ships them, so a rank only ever holds its own
partition's activations plus an ``m*H``-row halo strip.

Everything here but the exchange is static numpy: :func:`build_halo_program`
computes, on the host and identically on every rank, the per-partition
padded node and edge tables (sources extended into the halo strip) and the
``send_idx`` gather maps, with one halo width ``H`` (the largest boundary
set over all ordered partition pairs).  Each rank moves only its own slice
to its device (:func:`rank_round`).

Padding is inert as in :mod:`repro_torch.graph.sampling`: pad feature rows
are zero, pad edges carry weight 0 and point at local node 0, pad send slots
gather local row 0 but no edge reads the halo rows they fill, and the
exchange's backward leaves them out.

The group (``mesh=``) is a process group; ``None`` is the default group when
``torch.distributed`` is initialized and a world of one rank (no collective
at all) otherwise.  NCCL serves one card per rank, gloo two ranks on one
card and the CPU; the caller picks the backend in its
``init_process_group``.  gloo takes CUDA tensors in ``all_to_all_single``
and ``all_reduce`` (it copies them through host memory inside the
collective), so two ranks can share one card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.graph.data import Graph
from repro_torch.graph.models import CSR, Adjacency, _csr, adjacency, spmm
from repro_torch.graph.sampling import _bucket, bfs_partition, random_partition


# ------------------------------------------------------------------ groups
def graph_mesh(n_parts: int, group=None):
    """The process group the mesh engine trains ``n_parts`` partitions on:
    ``group``, else the default group when ``torch.distributed`` is
    initialized, else None (a world of one rank).  Its size must divide
    ``n_parts``.  The reference instead picks the largest divisor of
    ``n_parts`` that fits the host's devices; a rank cannot sit idle the way
    a spare device can, so the port raises."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    m = dp_size(group)
    if n_parts % m:
        raise ValueError(f"n_parts={n_parts} must be a multiple of the "
                         f"graph-mesh size {m}")
    return group


def dp_size(group) -> int:
    """Ranks in ``group`` (1 for None, a world of one rank)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


# ----------------------------------------------------------------- program
@dataclasses.dataclass
class HaloProgram:
    """Static per-round tables of mesh-sharded training.

    Leading axes are ``(rounds, m, ...)``; rank ``i`` reads index ``i`` of
    round ``r``.  ``features`` stays in host memory: the feature pager
    (:class:`repro_torch.offload.pager.FeaturePager`) moves it.
    ``send_count`` (the real slots of each send map) is the port's own: the
    exchange's backward sums over real slots only."""

    n_parts: int
    group: int                 # m: partitions co-resident per round
    rounds: int
    n_pad: int                 # padded nodes per partition
    e_pad: int                 # padded edges per partition
    halo: int                  # H: padded halo rows per (sender, receiver)
    part: np.ndarray           # (N,) global partition assignment
    features: np.ndarray       # (rounds, m, n_pad, F) f32, host-resident
    labels: np.ndarray         # (rounds, m, n_pad) i32
    train_mask: np.ndarray     # (rounds, m, n_pad) f32, owned real rows
    node_mask: np.ndarray      # (rounds, m, n_pad) f32, real rows
    edge_src: np.ndarray       # (rounds, m, e_pad) i32, extended indices
    edge_dst: np.ndarray       # (rounds, m, e_pad) i32, local indices
    gcn_weight: np.ndarray     # (rounds, m, e_pad) f32
    mean_weight: np.ndarray    # (rounds, m, e_pad) f32
    send_idx: np.ndarray       # (rounds, m, m, H) i32, sender-local rows
    n_real_nodes: np.ndarray   # (rounds, m) i32
    n_real_edges: np.ndarray   # (rounds, m) i32
    dropped_edges: int         # cross-round edges (the mesh approximation)
    halo_edges: int            # kept edges with a remote (in-round) source
    send_count: np.ndarray     # (rounds, m, m) i32, real slots of send_idx


def build_halo_program(g: Graph, n_parts: int, group: int, *,
                       method: str = "bfs", seed: int = 0,
                       node_multiple: int = 64,
                       edge_multiple: int = 256) -> HaloProgram:
    """The static mesh layout of ``g`` for ``group`` ranks.

    Partitioning reuses the mini-batch engine's partitioners with the same
    seed, owned-node order (ascending global id), edge order (global) and
    pad buckets, so ``group == 1`` lays out
    :func:`repro_torch.graph.sampling.make_subgraph_batches`'s batches
    exactly."""
    if n_parts % group:
        raise ValueError(f"n_parts={n_parts} must be a multiple of the "
                         f"graph-mesh size {group}")
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
    rounds = n_parts // group

    owned = [np.flatnonzero(part == p) for p in range(n_parts)]
    n_pad = _bucket(max(len(o) for o in owned), node_multiple)
    loc = np.full(n, -1, np.int64)
    for o in owned:
        loc[o] = np.arange(len(o))

    ps, pd = part[src], part[dst]
    same_round = (ps // group) == (pd // group)
    dropped = int(np.sum(~same_round))

    # kept edges per destination partition, in global edge order
    kept = [np.flatnonzero((pd == p) & same_round) for p in range(n_parts)]
    e_pad = _bucket(max(len(k) for k in kept), edge_multiple)

    # boundary sets: needed[(q, p)] = sorted unique global nodes owned by q
    # that p's kept edges read; H is the one halo width
    needed: dict[tuple[int, int], np.ndarray] = {}
    halo_edges = 0
    H = 0
    for p in range(n_parts):
        r = p // group
        es, eps = src[kept[p]], ps[kept[p]]
        for q in range(r * group, (r + 1) * group):
            if q == p:
                continue
            u = np.unique(es[eps == q])
            needed[(q, p)] = u
            halo_edges += int(np.sum(eps == q))
            H = max(H, len(u))

    F = g.n_feats
    feats = np.asarray(g.features)
    labels = np.asarray(g.labels)
    gcn_w = np.asarray(g.gcn_weight)
    mean_w = np.asarray(g.mean_weight)
    tr = np.asarray(g.train_mask)

    o_feats = np.zeros((rounds, group, n_pad, F), np.float32)
    o_labels = np.zeros((rounds, group, n_pad), np.int32)
    o_train = np.zeros((rounds, group, n_pad), np.float32)
    o_nmask = np.zeros((rounds, group, n_pad), np.float32)
    o_esrc = np.zeros((rounds, group, e_pad), np.int32)
    o_edst = np.zeros((rounds, group, e_pad), np.int32)
    o_gw = np.zeros((rounds, group, e_pad), np.float32)
    o_mw = np.zeros((rounds, group, e_pad), np.float32)
    o_send = np.zeros((rounds, group, group, H), np.int32)
    o_count = np.zeros((rounds, group, group), np.int32)
    o_nreal = np.zeros((rounds, group), np.int32)
    o_ereal = np.zeros((rounds, group), np.int32)

    for p in range(n_parts):
        r, j = divmod(p, group)
        nodes = owned[p]
        nl = len(nodes)
        o_feats[r, j, :nl] = feats[nodes]
        o_labels[r, j, :nl] = labels[nodes]
        o_train[r, j, :nl] = tr[nodes].astype(np.float32)
        o_nmask[r, j, :nl] = 1.0
        o_nreal[r, j] = nl

        e = kept[p]
        el = len(e)
        es, ed, eps = src[e], dst[e], ps[e]
        s_loc = np.empty(el, np.int64)
        local = eps == p
        s_loc[local] = loc[es[local]]
        for i in range(group):
            q = r * group + i
            if q == p:
                continue
            sel = eps == q
            if not np.any(sel):
                continue
            # a remote source slots into the halo strip at its position in
            # the (sorted) boundary set q ships to p
            s_loc[sel] = (n_pad + i * H
                          + np.searchsorted(needed[(q, p)], es[sel]))
        o_esrc[r, j, :el] = s_loc
        o_edst[r, j, :el] = loc[ed]
        o_gw[r, j, :el] = gcn_w[e]
        o_mw[r, j, :el] = mean_w[e]
        o_ereal[r, j] = el

    # send maps: rank i's rows for peer j are the boundary set of
    # (q = r*m + i -> p = r*m + j), zero-padded to H
    for (q, p), u in needed.items():
        r, i = divmod(q, group)
        j = p % group
        o_send[r, i, j, :len(u)] = loc[u]
        o_count[r, i, j] = len(u)

    return HaloProgram(
        n_parts=n_parts, group=group, rounds=rounds, n_pad=n_pad,
        e_pad=e_pad, halo=H, part=part, features=o_feats, labels=o_labels,
        train_mask=o_train, node_mask=o_nmask, edge_src=o_esrc,
        edge_dst=o_edst, gcn_weight=o_gw, mean_weight=o_mw, send_idx=o_send,
        n_real_nodes=o_nreal, n_real_edges=o_ereal, dropped_edges=dropped,
        halo_edges=halo_edges, send_count=o_count)


# ------------------------------------------------------- one rank's tables
@dataclasses.dataclass
class HaloRound:
    """One rank's tables of one round, on its device: labels, masks, the
    extended aggregation matrix (``n_pad`` rows, ``n_pad + m*H`` columns;
    its transpose the other way round), the ``(m, H)`` send map and the
    exchange's backward (:func:`send_csr`)."""

    labels: torch.Tensor
    train_mask: torch.Tensor
    node_mask: torch.Tensor
    adj: Adjacency
    send_idx: torch.Tensor
    back: CSR


def send_csr(send_idx: np.ndarray, send_count: np.ndarray, n_rows: int,
             device) -> CSR:
    """The exchange's backward as a CSR of ones: row ``send_idx[j, s]`` sums
    the returned gradient row ``j*H + s`` over the real slots ``s <
    send_count[j]``, in slot order (a fixed order; pad slots left out)."""
    m, H = send_idx.shape
    real = np.arange(H)[None, :] < send_count[:, None]
    cols = np.flatnonzero(real.reshape(-1))
    rows = send_idx.reshape(-1)[cols].astype(np.int64)
    return _csr(rows, cols, np.ones(len(cols), np.float32), n_rows, device)


def rank_round(prog: HaloProgram, r: int, rank: int, arch: str,
               device) -> HaloRound:
    """Rank ``rank``'s slice of round ``r`` of ``prog`` on ``device``; the
    aggregation weights are ``arch``'s (row-mean for SAGE, GCN's
    symmetric normalization)."""
    w = prog.mean_weight if arch == "sage" else prog.gcn_weight
    n, width = prog.n_pad, prog.n_pad + prog.group * prog.halo
    return HaloRound(
        labels=torch.from_numpy(prog.labels[r, rank].astype(np.int64)).to(
            device),
        train_mask=torch.from_numpy(prog.train_mask[r, rank]).to(device),
        node_mask=torch.from_numpy(prog.node_mask[r, rank]).to(device),
        adj=adjacency(prog.edge_src[r, rank].astype(np.int64),
                      prog.edge_dst[r, rank].astype(np.int64),
                      w[r, rank], n, device, n_src=width),
        send_idx=torch.from_numpy(prog.send_idx[r, rank].astype(np.int64)).to(
            device),
        back=send_csr(prog.send_idx[r, rank], prog.send_count[r, rank], n,
                      device))


# ---------------------------------------------------------------- exchange
def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``x``'s ``m`` equal chunks along dim 0.  A
    gloo group takes CUDA tensors itself (it stages them through host
    memory inside the collective), so no backend needs a path of its own."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _HaloExchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, send_idx, back, group):
        m, H = send_idx.shape
        sb = h.index_select(0, send_idx.reshape(-1))
        recv = _all_to_all(sb, group)
        ctx.n, ctx.back, ctx.group = h.shape[0], back, group
        return torch.cat([h, recv], dim=0)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        # the inverse exchange returns each peer's gradient of the rows sent
        # to it; the gather's transpose sums them in slot order
        back = _all_to_all(g[n:].contiguous(), ctx.group)
        return g[:n] + spmm(back, ctx.back), None, None, None


def halo_exchange(h: torch.Tensor, send_idx: torch.Tensor, back: CSR,
                  group=None) -> torch.Tensor:
    """Ship boundary rows between the round's co-resident partitions.

    ``h`` is this rank's ``(n_pad, F)`` block, ``send_idx`` its ``(m, H)``
    gather map (row ``i`` = the local rows peer ``i`` needs).  Returns the
    extended ``(n_pad + m*H, F)`` block whose halo strip holds, at ``n_pad
    + i*H + s``, row ``s`` of the boundary set partition ``i`` ships here:
    where :func:`build_halo_program` pointed the extended edge sources.

    Differentiable: the backward runs the inverse ``all_to_all_single`` on
    the strip's gradient and adds it into the sent rows through ``back``
    (the :func:`send_csr` of ``send_idx`` over its real slots) by the
    deterministic ``spmm``, never an atomic scatter.  ``H == 0``, ``m == 1``
    or ``group is None`` return ``h`` itself."""
    m, H = send_idx.shape
    if H == 0 or group is None or m == 1:
        return h
    return _HaloExchange.apply(h, send_idx, back, group)


# ------------------------------------------------------------------- bytes
def exchange_widths(arch: str, dims) -> tuple[int, ...]:
    """Per-layer exchanged row widths: GCN aggregates after the linear, so it
    exchanges the biased pre-aggregation output (``d_out`` wide); SAGE
    aggregates the layer input, so it exchanges ``h`` (``d_in`` wide)."""
    dims = list(dims)
    return tuple(dims[1:]) if arch == "gcn" else tuple(dims[:-1])


def halo_bytes_per_round(prog: HaloProgram, widths) -> int:
    """f32 bytes sent in one round, summed over the ``m`` ranks: each ships
    an ``(m, H, width)`` buffer a layer."""
    if prog.halo == 0:
        return 0
    per_layer = prog.group * prog.group * prog.halo * 4
    return int(per_layer * sum(widths))


def halo_bytes_per_epoch(prog: HaloProgram, widths) -> int:
    """f32 bytes sent per epoch, summed over the ranks."""
    return prog.rounds * halo_bytes_per_round(prog, widths)
