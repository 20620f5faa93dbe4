"""GCN (Kipf-Welling, paper Eq. 1) and GraphSAGE with EXACT-style
activation compression: the model, the sparse aggregation and the 1-bit
ReLU mask.

Compression placement matches EXACT/i-EXACT (and the reference's
``repro.graph.models``): the dense input of every linear is stored
compressed, ReLU saves a packed 1-bit sign mask, and the sparse aggregation
stores nothing (its backward needs only the graph).  The stash-aware
training forward is :mod:`repro_torch.engine.forward`; :class:`GNN`'s own
``forward`` is the primal pass (evaluation), whose values the compressed
forward shares exactly.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.core import pack as packmod
from repro_torch.core.compressor import CompressionConfig
from repro_torch.core.device import resolve_device


# ------------------------------------------------------------- 1-bit ReLU
def relu_mask(z: torch.Tensor) -> torch.Tensor:
    """Packed 1-bit sign mask of the flattened ``z`` (one strided row)."""
    return packmod.pack((z > 0).reshape(1, -1), 1)


def unpack_relu_mask(words: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`relu_mask`: a {0, 1} int32 tensor of ``shape``."""
    return packmod.unpack(words, 1, math.prod(shape)).reshape(shape)


# ------------------------------------------------------------------ SpMM
#: Most edges one spmm pass gathers: bounds its (edges, F) f32 transient
#: (512 MiB at F = 256) whatever the graph's size.
SPMM_MAX_EDGES = 1 << 19


@dataclasses.dataclass(frozen=True)
class CSR:
    """Edges sorted stably by output row: row ``r`` sums
    ``vals[e] * h[cols[e]]`` over ``e`` in ``offsets[r]:offsets[r+1]``.
    ``parts`` cuts the rows into runs of at most ``SPMM_MAX_EDGES`` edges
    (a single heavier row stands alone): ``(r0, r1, e0, e1, offsets[r0:r1+1]
    - e0)``."""

    offsets: torch.Tensor      # (n + 1,) int64
    cols: torch.Tensor         # (E,) int64
    vals: torch.Tensor         # (E,) f32
    parts: tuple


def _row_parts(offsets: np.ndarray, max_edges: int) -> list[tuple[int, int]]:
    n = len(offsets) - 1
    bounds = [0]
    while bounds[-1] < n:
        r = int(np.searchsorted(offsets, offsets[bounds[-1]] + max_edges,
                                side="right")) - 1
        bounds.append(min(max(r, bounds[-1] + 1), n))
    return list(zip(bounds[:-1], bounds[1:]))


def _csr(rows: np.ndarray, cols: np.ndarray, w: np.ndarray, n: int,
         device, max_edges: int = SPMM_MAX_EDGES) -> CSR:
    order = np.argsort(rows, kind="stable")
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=offsets[1:])
    parts = tuple(
        (r0, r1, int(offsets[r0]), int(offsets[r1]),
         torch.from_numpy(offsets[r0:r1 + 1] - offsets[r0]).to(device))
        for r0, r1 in _row_parts(offsets, max_edges))
    return CSR(torch.from_numpy(offsets).to(device),
               torch.from_numpy(cols[order]).to(device),
               torch.from_numpy(w[order]).to(device), parts)


@dataclasses.dataclass(frozen=True)
class Adjacency:
    """The aggregation matrix A (``out[d] = sum_e w_e h[s_e]``) by
    destination, and its transpose (by source) for the backward; built once
    per graph."""

    fwd: CSR
    bwd: CSR


def adjacency(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              n_nodes: int, device) -> Adjacency:
    s, d, w = src.numpy(), dst.numpy(), w.numpy()
    return Adjacency(fwd=_csr(d, s, w, n_nodes, device),
                     bwd=_csr(s, d, w, n_nodes, device))


def spmm(h: torch.Tensor, a: CSR) -> torch.Tensor:
    """The A-product the reference computes as ``segment_sum(h[src] * w,
    dst)``, as a segment sum over the row-sorted edges, one run of rows
    (``a.parts``) at a time so the gathered (edges, F) rows stay bounded.
    Deterministic on CUDA: each output element is summed in edge order by
    one thread (the cuSPARSE CSR and COO products, and an atomic
    ``index_add_``, vary from run to run in the last bits)."""
    out = h.new_empty((a.offsets.shape[0] - 1, h.shape[1]))
    for r0, r1, e0, e1, offsets in a.parts:
        m = h.index_select(0, a.cols[e0:e1])
        m.mul_(a.vals[e0:e1, None])
        out[r0:r1] = torch.segment_reduce(m, "sum", offsets=offsets, axis=0)
        del m  # else the next run's gather is allocated while this one lives
    return out


# ----------------------------------------------------------------- model
@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """``compression`` is heterogeneous-precision aware: a single
    ``CompressionConfig`` is broadcast to every layer, while a tuple
    carries one entry per GNN layer (``len(hidden) + 1``; ``None`` entries
    leave that layer uncompressed, its linear input stashed as raw f32).
    :meth:`layer_compression` is the per-layer view every consumer (the
    stash forward, the byte ledger, autoprec) reads.

    ``dropout`` is carried for configs written for the reference; training
    applies none, as the reference's training engine reads no dropout
    either (only its per-op ``gnn_forward`` takes a dropout key)."""

    arch: str = "sage"                 # "gcn" | "sage"
    hidden: tuple[int, ...] = (256, 256)
    n_classes: int = 40
    compression: (CompressionConfig | None
                  | tuple[CompressionConfig | None, ...]) = None
    dropout: float = 0.0

    @property
    def n_layers(self) -> int:
        return len(self.hidden) + 1

    def layer_compression(self) -> tuple[CompressionConfig | None, ...]:
        """Per-layer compression configs, broadcasting a shared one."""
        if self.compression is None:
            return (None,) * self.n_layers
        if isinstance(self.compression, CompressionConfig):
            return (self.compression,) * self.n_layers
        per = tuple(self.compression)
        if len(per) != self.n_layers:
            raise ValueError(
                f"per-layer compression tuple has {len(per)} entries for a "
                f"{self.n_layers}-layer model")
        return per

    def with_layer_bits(self, bits) -> "GNNConfig":
        """Pin each layer's quantization width (autoprec's output): one
        entry per layer; a falsy entry (0 or None), or one on an
        uncompressed layer, leaves that layer as it is."""
        per = self.layer_compression()
        if len(bits) != self.n_layers:
            raise ValueError(
                f"got {len(bits)} bit-widths for {self.n_layers} layers")
        return dataclasses.replace(self, compression=tuple(
            c if c is None or not b else dataclasses.replace(c, bits=int(b))
            for c, b in zip(per, bits)))

    def with_impl(self, impl: str) -> "GNNConfig":
        """Same model, compression routed through another kernel backend
        (an uncompressed config is returned as it is)."""
        if self.compression is None:
            return self
        if isinstance(self.compression, CompressionConfig):
            return dataclasses.replace(
                self, compression=self.compression.with_impl(impl))
        return dataclasses.replace(self, compression=tuple(
            None if c is None else c.with_impl(impl)
            for c in self.compression))


def _dims(cfg: GNNConfig, in_dim: int):
    return [in_dim, *cfg.hidden, cfg.n_classes]


@dataclasses.dataclass
class DeviceGraph:
    """What training reads of a :class:`~repro_torch.graph.data.Graph` or a
    :class:`~repro_torch.graph.sampling.SubgraphBatch`, on its device:
    features, labels, float masks, the aggregation matrix the architecture
    uses (row-mean for SAGE, symmetric-normalized for GCN) and, for a padded
    batch, ``node_mask`` ((N,) f32, 1 on real rows): the forward pins the
    other rows to zero after every layer.  ``None`` (the full graph) skips
    those multiplies."""

    features: torch.Tensor
    labels: torch.Tensor
    train_mask: torch.Tensor
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    adj: Adjacency
    node_mask: torch.Tensor | None = None


def device_graph(g, arch: str, device) -> DeviceGraph:
    """``g`` (a Graph or a SubgraphBatch) on ``device``.  A batch's padding
    edges (weight 0, node 0 to node 0) stay in its CSR rows, as the
    reference keeps them in its edge list."""
    w = g.mean_weight if arch == "sage" else g.gcn_weight
    nm = getattr(g, "node_mask", None)
    return DeviceGraph(
        features=g.features.to(device), labels=g.labels.to(device),
        train_mask=g.train_mask.to(device, torch.float32),
        val_mask=g.val_mask.to(device, torch.float32),
        test_mask=g.test_mask.to(device, torch.float32),
        adj=adjacency(g.edge_src, g.edge_dst, w, g.n_nodes, device),
        node_mask=None if nm is None else nm.to(device, torch.float32))


class GNN(nn.Module):
    """The GNN's parameters in the reference's layout (``w`` is
    (fan_in, d_out), fan_in doubled for SAGE's [h, mean(h)] concat);
    ``forward`` is the primal pass."""

    def __init__(self, cfg: GNNConfig, in_dim: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dims = _dims(cfg, in_dim)
        ws, bs = [], []
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            fan_in = d_in * (2 if cfg.arch == "sage" else 1)
            ws.append(nn.Parameter(torch.randn(fan_in, d_out,
                                               generator=generator)
                                   / math.sqrt(fan_in)))
            bs.append(nn.Parameter(torch.zeros(d_out)))
        self.weights = nn.ParameterList(ws)
        self.biases = nn.ParameterList(bs)

    def flat_params(self) -> list[torch.Tensor]:
        """``[w0, b0, w1, b1, ...]``: the order the engine's forward takes."""
        return [t for wb in zip(self.weights, self.biases) for t in wb]

    def forward(self, graph: DeviceGraph) -> torch.Tensor:
        """The primal pass; a padded batch's rows outside ``node_mask`` are
        pinned to zero at the input and after every layer (the reference's
        ``gnn_forward(node_mask=)``)."""
        nm = None if graph.node_mask is None else graph.node_mask[:, None]
        h = graph.features if nm is None else graph.features * nm
        n_layers = len(self.weights)
        for li, (w, b) in enumerate(zip(self.weights, self.biases)):
            if self.cfg.arch == "gcn":
                z = spmm(h @ w + b, graph.adj.fwd)
            else:
                z = torch.cat([h, spmm(h, graph.adj.fwd)], dim=1) @ w + b
            h = torch.relu(z) if li < n_layers - 1 else z
            if nm is not None:
                h = h * nm
        return h


def params_from_numpy(params, cfg: GNNConfig, device="cuda") -> GNN:
    """A :class:`GNN` holding the reference's params (a list of
    ``{"w": ndarray, "b": ndarray}``), so both packages start alike, on
    ``device`` (the card unless the CPU is asked for; raises without one)."""
    device = resolve_device(device)
    in_dim = params[0]["w"].shape[0] // (2 if cfg.arch == "sage" else 1)
    model = GNN(cfg, in_dim)
    with torch.no_grad():
        for w, b, p in zip(model.weights, model.biases, params):
            w.copy_(torch.tensor(np.asarray(p["w"], np.float32)))
            b.copy_(torch.tensor(np.asarray(p["b"], np.float32)))
    return model.to(device)
