"""THE stash-aware GNN training forward: one ``torch.autograd.Function``
over the whole network (the reference's ``repro.engine.forward``).

Forward: the primal layer math of :class:`repro_torch.graph.models.GNN`
with the per-layer seeds of :mod:`repro_torch.engine.seeds`; each layer's
stash (its compressed linear input, or the raw f32 input of an
uncompressed layer, and on hidden layers the packed 1-bit ReLU mask) goes
through a writer of :mod:`repro_torch.offload.engine`: per-tensor, or into
an arena on the device or in host memory.

Backward: the reference's manual reverse walk line for line, reading the
stash back through the writer's reader, which brings layer ``li - 1``'s
segments back before layer ``li``'s gradient math (one layer ahead; a
no-op for device-resident stashes) and drops each layer once consumed.  A
padded batch's ``node_mask`` is applied to each layer's incoming gradient
as to each layer's output: ``dx = g w^T`` exact, ``dw = x_hat^T g`` at the
reconstruction (EXACT's estimator), ReLU through the saved sign mask, and
the A-product transposed through the adjacency's transpose.  The features
take no gradient, so the walk stops at layer 0's parameter gradients.

Saved for backward: the stash above, the params and the graph; nothing
else.  Per-op autograd would keep f32 activations alive (``h[src]``, the
concat, the ReLU input), which is what the system exists to avoid.
"""
from __future__ import annotations

import torch

from repro_torch.core.act_compress import compressed_linear
from repro_torch.core.act_compress import stash_nbytes as linear_nbytes
from repro_torch.core.compressor import compress_matmul, decompress_matmul
from repro_torch.engine import seeds
from repro_torch.graph.models import (DeviceGraph, GNNConfig, aggregate,
                                      relu_1bit, relu_mask, spmm,
                                      unpack_relu_mask)
from repro_torch.obs.trace import span
from repro_torch.offload import engine as stash_engine
from repro_torch.offload.engine import ArenaStore
from repro_torch.parallel.halo import halo_exchange


class _StashGNN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, graph: DeviceGraph, cfg: GNNConfig, seed: int,
                fused: str, store: ArenaStore | None, *flat_params):
        params = list(zip(flat_params[0::2], flat_params[1::2]))
        per_layer = cfg.layer_compression()
        sage = cfg.arch == "sage"
        n_layers = len(params)
        writer = stash_engine.make_writer(store, n_layers)
        # a padded batch pins its pad rows to zero (x * 1 is exact, but the
        # full graph skips the passes)
        nm = None if graph.node_mask is None else graph.node_mask[:, None]
        h = graph.features if nm is None else graph.features * nm
        for li, (w, b) in enumerate(params):
            x = torch.cat([h, spmm(h, graph.adj.fwd)], dim=1) if sage else h
            comp = per_layer[li]
            if comp is None:
                writer.put_raw(li, x)
                with span("gnn/linear", layer=li, dir="fwd"):
                    z = x @ w + b
            else:
                # fused: x is quantized beside its product (one read of
                # x); route_fused falls back to two passes per layer
                with span("gnn/linear", layer=li, dir="fwd"):
                    y, ct = compress_matmul(x, w, comp,
                                            seeds.layer_seed(seed, li),
                                            fused=fused)
                writer.put_ct(li, ct)
                z = y + b
            if not sage:
                z = spmm(z, graph.adj.fwd)
            if li < n_layers - 1:
                writer.put_mask(li, relu_mask(z))
                z = torch.relu(z)
            h = z if nm is None else z * nm
        ctx.save_for_backward(*flat_params)
        ctx.graph, ctx.cfg, ctx.fused = graph, cfg, fused
        ctx.stash, ctx.stash_bytes = writer.residual(), writer.nbytes()
        return h

    @staticmethod
    def backward(ctx, gy):
        flat_params = ctx.saved_tensors
        params = list(zip(flat_params[0::2], flat_params[1::2]))
        adj_t = ctx.graph.adj.bwd
        per_layer = ctx.cfg.layer_compression()
        sage = ctx.cfg.arch == "sage"
        n_layers = len(params)
        grads = [None] * len(flat_params)
        nm = (None if ctx.graph.node_mask is None
              else ctx.graph.node_mask[:, None])
        # the reader frees each layer's stash once consumed
        reader = stash_engine.make_reader(ctx.stash)
        ctx.stash = None
        reader.prefetch(n_layers - 1)
        gh = gy
        for li in reversed(range(n_layers)):
            if li > 0:
                reader.prefetch(li - 1)     # one layer ahead of the compute
            w, _ = params[li]
            g = gh if nm is None else gh * nm
            if li < n_layers - 1:
                g = g * unpack_relu_mask(reader.get_mask(li),
                                         g.shape).to(g.dtype)
            # transpose of the output-side A-product (GCN applies it after
            # the linear)
            gz = g if sage else spmm(g, adj_t)
            with span("gnn/linear", layer=li, dir="bwd"):
                if per_layer[li] is not None:
                    # fused: the stash is dequantized in the product's
                    # prologue
                    dw = decompress_matmul(reader.get_ct(li), gz,
                                           fused=ctx.fused)
                else:
                    dw = reader.get_raw(li).T @ gz
                # the features take no gradient
                gx = gz @ w.T if li > 0 else None
            grads[2 * li] = dw.to(w.dtype)
            grads[2 * li + 1] = gz.sum(dim=0)
            if li == 0:
                break
            if sage:
                d = gx.shape[1] // 2
                gh = gx[:, :d] + spmm(gx[:, d:], adj_t)
            else:
                gh = gx
        return (None, None, None, None, None, *grads)


def stash_gnn_forward(model, graph: DeviceGraph, cfg: GNNConfig,
                      seed: int = 0, fused: str = "auto",
                      store: ArenaStore | None = None) -> torch.Tensor:
    """Logits of ``model`` on ``graph`` with every layer's stash saved for
    the manual backward (``cfg`` carries the compression configs).

    ``fused`` ("auto" | "on" | "off") routes each compressed layer's matmul
    pair (:func:`repro_torch.core.backend.route_fused`): "auto" fuses the
    eligible layers on the card, "on" fuses every layer or raises, "off"
    keeps the two-pass spelling.  ``store`` (an
    :class:`~repro_torch.offload.engine.ArenaStore` for this config's
    :func:`~repro_torch.offload.gnn.plan_gnn_stashes` plan) pools the stash
    at its placement; None keeps per-tensor stashes."""
    if len(model.weights) != cfg.n_layers:
        raise ValueError(f"model has {len(model.weights)} layers for a "
                         f"{cfg.n_layers}-layer config")
    return _StashGNN.apply(graph, cfg, int(seed), fused, store,
                           *model.flat_params())


def stash_nbytes(logits: torch.Tensor) -> list[int]:
    """Bytes of each layer's stash behind ``logits`` (the output of
    :func:`stash_gnn_forward`): per-tensor, counted from the tensors the
    step holds; in an arena, the plan's per-layer bytes."""
    return list(logits.grad_fn.stash_bytes)


# ------------------------------------------------------------ mesh forward
def mesh_gnn_forward(model, feats: torch.Tensor, tables, cfg: GNNConfig, *,
                     seed: int, group=None):
    """One rank's slice of the mesh-sharded GNN forward: the layer math of
    :func:`stash_gnn_forward` composed from the per-op Functions
    (:func:`~repro_torch.core.act_compress.compressed_linear`,
    :func:`~repro_torch.graph.models.relu_1bit`,
    :func:`~repro_torch.graph.models.aggregate`), with the same operations
    in the same order, so a world of one rank gives the engine's bits; and
    before each aggregation :func:`~repro_torch.parallel.halo.halo_exchange`
    extends the aggregated tensor with the round-mates' boundary rows.  GCN
    exchanges the biased pre-aggregation output, SAGE ``h`` ahead of its
    mean aggregation.  ``tables`` is the rank's
    :class:`~repro_torch.parallel.halo.HaloRound`.

    Returns the logits, each layer's stash bytes (the compressed or raw
    linear input and, on hidden layers, the packed ReLU mask: only local
    rows are stashed, so the stash plan is ``plan_gnn_stashes`` at the
    partition's padded node count) and the bytes this rank's
    exchanges sent (its ``(m, H, F)`` send buffers)."""
    per_layer = cfg.layer_compression()
    params = list(zip(model.weights, model.biases))
    nm = tables.node_mask[:, None]
    sent = 0

    def exchange(t):
        nonlocal sent
        out = halo_exchange(t, tables.send_idx, tables.back, group)
        # the strip holds as many rows as the send buffer
        sent += (out.shape[0] - t.shape[0]) * t.shape[1] * t.element_size()
        return out

    h = feats * nm
    stash = []
    for li, (w, b) in enumerate(params):
        lseed = seeds.layer_seed(seed, li)
        if cfg.arch == "gcn":
            z = compressed_linear(h, w, b, lseed, per_layer[li])
            nbytes = linear_nbytes(z)
            z = aggregate(exchange(z), tables.adj)
        else:
            x = torch.cat([h, aggregate(exchange(h), tables.adj)], dim=1)
            z = compressed_linear(x, w, b, lseed, per_layer[li])
            nbytes = linear_nbytes(z)
        if li < len(params) - 1:
            z = relu_1bit(z)
            nbytes += z.grad_fn.saved_tensors[0].numel() * 4
        stash.append(nbytes)
        h = z * nm
    return h, stash, sent
