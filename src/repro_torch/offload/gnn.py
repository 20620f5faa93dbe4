"""GNN stash planning (the reference's ``repro.offload.gnn``):
:func:`plan_gnn_stashes`, the static arena layout of one GNN forward.  The
whole-network forward that consumes it is
:mod:`repro_torch.engine.forward`."""
from __future__ import annotations

from repro_torch.offload.arena import StashPlan, plan_stashes


def plan_gnn_stashes(cfg, in_dim: int, n_nodes: int) -> StashPlan:
    """Static arena layout for one GNN forward over ``n_nodes`` live rows
    (the full graph, or one padded subgraph batch).

    Layer li stashes its linear input ``(n_nodes, d_in * (2 if sage))`` at
    the layer's own :class:`CompressionConfig` (``None`` layers as raw
    f32), and hidden layers add the word-aligned 1-bit ReLU mask over their
    output."""
    # deferred: the graph package imports the engine's plan, which imports
    # this package
    from repro_torch.graph.models import _dims

    dims = _dims(cfg, in_dim)
    shapes, masks = [], []
    for li, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        lin_in = d_in * (2 if cfg.arch == "sage" else 1)
        shapes.append((n_nodes, lin_in))
        masks.append(n_nodes * d_out if li < len(dims) - 2 else 0)
    return plan_stashes(tuple(shapes), cfg.layer_compression(), tuple(masks))
