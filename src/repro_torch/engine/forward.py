"""THE stash-aware GNN training forward: one ``torch.autograd.Function``
over the whole network (the reference's ``repro.engine.forward``, with the
per-tensor stash).

Forward: the primal layer math of :class:`repro_torch.graph.models.GNN`
with the per-layer seeds of :mod:`repro_torch.engine.seeds`; each layer
stashes its compressed linear input (or the raw f32 input for an
uncompressed layer) and, on hidden layers, the packed 1-bit ReLU mask.

Backward: the reference's manual reverse walk (``engine/forward.py``
124-167) line for line: ``dx = g w^T`` exact, ``dw = x_hat^T g`` at the
reconstruction (EXACT's estimator), ReLU through the saved sign mask, and
the A-product transposed through the adjacency's transpose.  The features
take no gradient, so the walk stops at layer 0's parameter gradients.

Saved for backward: the stash above, the params and the graph; nothing
else.  Per-op autograd would keep f32 activations alive (``h[src]``, the
concat, the ReLU input), which is what the system exists to avoid.
"""
from __future__ import annotations

import torch

from repro_torch.core.compressor import compress_matmul, decompress_matmul
from repro_torch.engine import seeds
from repro_torch.graph.models import (DeviceGraph, GNNConfig, relu_mask,
                                      spmm, unpack_relu_mask)


class _StashGNN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, graph: DeviceGraph, cfg: GNNConfig, seed: int,
                *flat_params):
        params = list(zip(flat_params[0::2], flat_params[1::2]))
        per_layer = cfg.layer_compression()
        sage = cfg.arch == "sage"
        n_layers = len(params)
        stash = []
        h = graph.features
        for li, (w, b) in enumerate(params):
            x = torch.cat([h, spmm(h, graph.adj.fwd)], dim=1) if sage else h
            comp = per_layer[li]
            if comp is None:
                entry = {"raw": x}
                z = x @ w + b
            else:
                y, ct = compress_matmul(x, w, comp, seeds.layer_seed(seed, li))
                entry = {"ct": ct}
                z = y + b
            if not sage:
                z = spmm(z, graph.adj.fwd)
            if li < n_layers - 1:
                entry["mask"] = relu_mask(z)
                z = torch.relu(z)
            stash.append(entry)
            h = z
        ctx.save_for_backward(*flat_params)
        ctx.graph, ctx.cfg, ctx.stash = graph, cfg, stash
        return h

    @staticmethod
    def backward(ctx, gy):
        flat_params = ctx.saved_tensors
        params = list(zip(flat_params[0::2], flat_params[1::2]))
        adj_t = ctx.graph.adj.bwd
        sage = ctx.cfg.arch == "sage"
        n_layers = len(params)
        grads = [None] * len(flat_params)
        gh = gy
        for li in reversed(range(n_layers)):
            w, _ = params[li]
            entry = ctx.stash[li]
            ctx.stash[li] = None            # free this layer's stash early
            g = gh
            if li < n_layers - 1:
                g = g * unpack_relu_mask(entry["mask"], g.shape).to(g.dtype)
            # transpose of the output-side A-product (GCN applies it after
            # the linear)
            gz = g if sage else spmm(g, adj_t)
            if "ct" in entry:
                dw = decompress_matmul(entry["ct"], gz)
            else:
                dw = entry["raw"].T @ gz
            grads[2 * li] = dw.to(w.dtype)
            grads[2 * li + 1] = gz.sum(dim=0)
            if li == 0:
                break   # the features take no gradient
            gx = gz @ w.T
            if sage:
                d = gx.shape[1] // 2
                gh = gx[:, :d] + spmm(gx[:, d:], adj_t)
            else:
                gh = gx
        return (None, None, None, *grads)


def stash_gnn_forward(model, graph: DeviceGraph, cfg: GNNConfig,
                      seed: int = 0) -> torch.Tensor:
    """Logits of ``model`` on ``graph`` with every layer's stash saved for
    the manual backward (``cfg`` carries the compression configs)."""
    if len(model.weights) != cfg.n_layers:
        raise ValueError(f"model has {len(model.weights)} layers for a "
                         f"{cfg.n_layers}-layer config")
    return _StashGNN.apply(graph, cfg, int(seed), *model.flat_params())


def stash_nbytes(logits: torch.Tensor) -> list[int]:
    """Bytes of each layer's live stash behind ``logits`` (the output of
    :func:`stash_gnn_forward`, before its backward has run), counted from
    the tensors the step actually holds."""
    per_layer = []
    for entry in logits.grad_fn.stash:
        n = 0
        if "ct" in entry:
            n += entry["ct"].nbytes
        for key in ("raw", "mask"):
            if key in entry:
                n += entry[key].numel() * entry[key].element_size()
        per_layer.append(n)
    return per_layer
