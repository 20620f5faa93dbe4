"""GNN training entry points over the engine (:mod:`repro_torch.engine`):
full-graph training (the paper's Table 1 loop), partition-sampled
mini-batch training (Cluster-GCN flavour, data parallel over a process
group), mesh-sharded partition-parallel training, and the Table-1 "M"
column with its mini-batch and mesh sections
(:func:`activation_memory_report`).  Each entry point
builds an :class:`~repro_torch.engine.plan.ExecutionPlan` from its keywords
and hands it to :func:`repro_torch.engine.runner.run`."""
from __future__ import annotations

from repro_torch.engine.plan import ExecutionPlan, KernelPolicy, SamplingPolicy
from repro_torch.graph.analysis import saved_bytes_per_layer
from repro_torch.graph.data import Graph
from repro_torch.graph.models import GNN, GNNConfig
from repro_torch.graph.sampling import _bucket
from repro_torch.offload.engine import (check_policy, device_memory_stats,
                                        device_resident_stash_bytes,
                                        measure_live_bytes)
from repro_torch.offload.gnn import plan_gnn_stashes
from repro_torch.optim import AdamWConfig


def train_gnn(g: Graph, cfg: GNNConfig, opt: AdamWConfig | None = None,
              n_epochs: int = 100, seed: int = 0, params: GNN | None = None,
              impl: str = "auto", fused: str = "auto",
              bit_budget: float | None = None, autoprec_refresh: int = 0,
              offload: str | None = None, device="cuda") -> dict:
    """Full-graph training; returns dict(test_acc, val_acc, history,
    epochs_per_sec, model, stash_bytes, cfg, plan) (see
    :func:`repro_torch.engine.runner.run`).

    Runs on the card unless ``device="cpu"``; with no CUDA device and no
    explicit ``"cpu"`` it raises.  ``impl`` routes the compression stack:
    ``"cuda"`` (the kernels), ``"torch"`` (the plain versions) or ``"auto"``
    (``"cuda"`` on a CUDA device, ``"torch"`` on the CPU).  ``params`` (a
    :class:`GNN`, e.g. from :func:`repro_torch.graph.models.params_from_numpy`)
    sets the initial weights; by default they are drawn from ``seed``.

    ``fused`` ("auto" | "on" | "off") governs the fused matmul-quant pair
    (the reference's ``train_gnn(fused=)``): "auto" fuses every eligible
    layer on the card when ``rp_ratio <= 1`` (2-D operand, blocks aligned to
    rows, whole blocks and words, at most 16 levels) and runs the two-pass
    spelling elsewhere, "on" forces the pair (the plain composition on the
    CPU, the same bits) and raises on an ineligible layer, "off" never
    fuses.

    ``bit_budget`` turns on variance-guided adaptive precision
    (:mod:`repro_torch.core.autoprec`): the average stash bits per element
    (2.0 = the fixed-INT2 footprint), converted once to a byte ceiling and
    split across layers (widths in ``BIT_CHOICES``) by minimizing the
    total expected SR variance, from range moments and a two-seed gradient
    probe.  ``autoprec_refresh=k`` re-solves every k epochs (0 = allocate
    once); a changed allocation recompiles the step.  The result then
    carries ``bits_per_layer`` and ``bit_budget_bytes``.

    ``offload`` pools the stash into one u32 and one f32 arena
    (:mod:`repro_torch.offload`): ``"device"`` keeps the arena on the card;
    ``"host"`` and ``"pinned-paged"`` copy each layer's segments to pageable
    or page-locked host memory on a side stream after its forward and bring
    them back one layer ahead of the backward, so at most two layers'
    segments are on the card.  Every placement is bit-identical to
    ``offload=None`` (the per-tensor stash); the result then carries
    ``arena`` (the plan's bytes, the prefetch window and the readers'
    gauges).

    Equivalent plan: ``ExecutionPlan.from_legacy(impl=impl, fused=fused,
    offload=offload, bit_budget=bit_budget,
    autoprec_refresh=autoprec_refresh)``.
    """
    from repro_torch.engine.runner import run  # lazy: engine <- graph

    plan = ExecutionPlan.from_legacy(
        impl=impl, fused=fused, offload=offload, bit_budget=bit_budget,
        autoprec_refresh=autoprec_refresh)
    return run(g, cfg, plan, opt, n_epochs=n_epochs, seed=seed,
               params=params, device=device)


def train_gnn_batched(g: Graph, cfg: GNNConfig, n_parts: int,
                      opt: AdamWConfig | None = None, n_epochs: int = 100,
                      seed: int = 0, *, method: str = "bfs", halo: int = 0,
                      grad_accum: int = 1, mesh=None, impl: str | None = None,
                      fused: str = "auto", node_multiple: int = 64,
                      edge_multiple: int = 256, renormalize: bool = False,
                      shuffle: bool = True, batches=None,
                      bit_budget: float | None = None,
                      autoprec_refresh: int = 0, offload: str | None = None,
                      params: GNN | None = None, device="cuda") -> dict:
    """Partition-sampled mini-batch training (Cluster-GCN flavour).

    Splits ``g`` into ``n_parts`` padded subgraph batches
    (:func:`repro_torch.graph.sampling.make_subgraph_batches`: ``method``,
    ``halo``, the bucket multiples, ``renormalize``), moves them to the
    device once, and trains one batch at a time, so the live stash is one
    padded batch's, not the whole graph's: the regime where the paper's
    block-wise compression matters.

    grad_accum   batches summed into each optimizer update; ``n_parts``
                 must be a multiple of it.
    shuffle      redraw the batch order every epoch (from
                 ``seeds.order_rng(seed)``).
    batches      a prebuilt batch list (skips partitioning).
    impl, fused, bit_budget, autoprec_refresh, offload, params, device
                 as in :func:`train_gnn`; autoprec calibrates on one padded
                 batch, so its byte ceiling is per batch, and an arena is
                 planned over one padded batch's rows.

    mesh         a ``torch.distributed`` process group of ``dp`` ranks
                 (every rank calls alike): each update takes ``dp *
                 grad_accum`` batches, rank ``i`` the positions ``a * dp +
                 i``, and the gradients are summed over the ranks before
                 the one AdamW update every rank takes.  ``n_parts`` must
                 be a multiple of ``dp * grad_accum``; the host offload
                 placements need ``dp == 1``.

    The batch at position ``p`` of epoch ``e`` stashes with ``sr_seed(e *
    n_parts + p)``, so ``n_parts=1`` with ``node_multiple=1,
    edge_multiple=1`` is :func:`train_gnn` bit for bit, and two ranks are
    one process at ``grad_accum=2`` bit for bit.  Evaluation runs on the
    full graph with the final weights.  Returns the :func:`train_gnn`
    result plus ``n_parts``, ``updates_per_epoch``, ``batch_nodes`` and
    ``batch_edges``; the history's loss is the mean over the epoch's
    updates.  The reference's ``eval_every`` and ``verbose`` are not taken:
    the history holds every epoch.
    """
    from repro_torch.engine.runner import run  # lazy: engine <- graph

    plan = ExecutionPlan.from_legacy(
        n_parts=n_parts, impl=impl, fused=fused, offload=offload,
        bit_budget=bit_budget, autoprec_refresh=autoprec_refresh,
        method=method, halo=halo, node_multiple=node_multiple,
        edge_multiple=edge_multiple, renormalize=renormalize,
        shuffle=shuffle, grad_accum=grad_accum)
    return run(g, cfg, plan, opt, n_epochs=n_epochs, seed=seed,
               params=params, device=device, batches=batches, mesh=mesh)


def train_gnn_mesh(g: Graph, cfg: GNNConfig, n_parts: int,
                   opt: AdamWConfig | None = None, n_epochs: int = 100,
                   seed: int = 0, *, method: str = "bfs", mesh=None,
                   impl: str | None = None, node_multiple: int = 64,
                   edge_multiple: int = 256, params: GNN | None = None,
                   device="cuda") -> dict:
    """Mesh-sharded partition-parallel GNN training.

    Shards ``n_parts`` graph partitions over the ``m`` ranks of ``mesh`` (a
    ``torch.distributed`` process group; None is the default group when
    ``torch.distributed`` is initialized, else a world of one rank) and
    trains them in ``n_parts // m`` rounds an epoch: one update a round, a
    per-layer halo exchange (:mod:`repro_torch.parallel.halo`) shipping
    cross-partition boundary rows, block-wise compression of each rank's
    local activations only, and the features in host memory behind the
    double-buffered :class:`repro_torch.offload.pager.FeaturePager`.  Every
    rank calls it alike.

    Parity (``tests/test_torch_mesh.py``): ``n_parts=1`` with exact padding
    is :func:`train_gnn` bit for bit; any ``n_parts`` on one rank is
    :func:`train_gnn_batched` with ``shuffle=False`` bit for bit; ``m ==
    n_parts`` keeps every edge (exact distributed full-graph training,
    within a float tolerance of one process).

    Returns the engine result plus the mesh extras (``mesh_devices``,
    ``halo_width``, ``halo_edges``, ``dropped_edges``,
    ``halo_bytes_per_epoch``, the rank's ``halo_bytes_sent`` and ``rank``,
    ``pager``).  The reference's ``eval_every`` and ``verbose`` are not
    taken: the history holds every epoch.

    Equivalent plan: ``ExecutionPlan(sampling=SamplingPolicy(kind="mesh",
    n_parts=n_parts, method=method, shuffle=False, ...))``.
    """
    from repro_torch.engine.runner import run  # lazy: engine <- graph

    plan = ExecutionPlan(
        sampling=SamplingPolicy(kind="mesh", n_parts=n_parts, method=method,
                                shuffle=False, node_multiple=node_multiple,
                                edge_multiple=edge_multiple),
        kernel=KernelPolicy(impl=impl))
    return run(g, cfg, plan, opt, n_epochs=n_epochs, seed=seed,
               params=params, device=device, mesh=mesh)


def activation_memory_report(g: Graph, cfg: GNNConfig, n_parts: int = 1,
                             batch_nodes: int | None = None,
                             node_multiple: int = 64,
                             offload: str | None = None,
                             plan: ExecutionPlan | None = None,
                             quant_health: list | None = None) -> dict:
    """Bytes of saved-for-backward activations: the paper's Table-1 "M"
    column model, per layer and, for partition sampling, per batch (the
    reference's keys):

    * ``fp32_bytes``: the f32 input of every linear plus the f32 ReLU
      context;
    * ``per_layer``: one dict per layer (``layer``, ``fp32_bytes``[,
      ``compressed_bytes``, ``bits``]);
    * when any layer is compressed, ``compressed_bytes`` (packed codes, one
      (zero, range) f32 pair a block, the RP seed and the word-aligned
      1-bit ReLU masks, each layer at its own width; an uncompressed layer
      counts its ``fp32_bytes``), ``reduction`` (1 - compressed / fp32)
      and ``bits_per_layer``;
    * with ``n_parts > 1`` or a partition or mesh ``plan`` (the plan's
      ``n_parts`` and ``node_multiple`` win), ``batched`` (``mesh`` for a
      mesh plan, which adds ``per_device_saved_bytes``: a rank stashes its
      partition's local rows only): batches run one at a time,
      so the peak stash is one padded batch of ``batch_nodes`` (default
      ceil(N / n_parts) rounded up to ``node_multiple``; pass the run's
      ``batch_nodes`` for halo or other buckets): ``n_parts``,
      ``batch_nodes``, ``peak_fp32_bytes``, ``peak_saved_bytes``,
      ``full_graph_saved_bytes``, ``peak_reduction_vs_full`` (full / peak)
      and that batch's ``per_layer``.

    With an arena stash (``offload=``, or a plan with an arena stash
    policy), ``arena``: the pooled ledger of the
    :func:`~repro_torch.offload.gnn.plan_gnn_stashes` plan over
    ``stash_nodes`` rows (an explicit ``batch_nodes``, else the graph's):
    ``policy``, ``planned_bytes`` split into ``u32_bytes`` and
    ``f32_bytes``, ``per_layer`` rows, ``device_resident_bytes`` (the whole
    arena, or the two-layer prefetch window of the host policies), and the
    measured ``measured_live_bytes`` (``torch.cuda.memory_allocated``, 0
    before the card is used) and ``device_peak_bytes``
    (``torch.cuda.max_memory_allocated``, None before the card is used).

    ``quant_health`` belongs to queue A.10 and raises."""
    if plan is None:
        plan = ExecutionPlan.from_legacy(
            n_parts=n_parts if n_parts > 1 else None,
            offload=check_policy(offload), node_multiple=node_multiple)
    if quant_health is not None:
        raise NotImplementedError("activation_memory_report(quant_health=) "
                                  "is not ported yet (ROADMAP A.10)")
    mesh_kind = plan.sampling.kind == "mesh"
    if plan.sampling.kind in ("partition", "mesh"):
        n_parts = plan.sampling.n_parts
        node_multiple = plan.sampling.node_multiple
    else:
        n_parts = 1
    per_layer = saved_bytes_per_layer(cfg, g.n_feats, g.n_nodes)
    has_comp = any("compressed_bytes" in r for r in per_layer)
    total_fp32 = sum(r["fp32_bytes"] for r in per_layer)
    out = {"fp32_bytes": total_fp32, "per_layer": per_layer}
    full_saved = total_fp32
    if has_comp:
        # mixed precision: a layer without compression counts its fp32 bytes
        total_c = sum(r.get("compressed_bytes", r["fp32_bytes"])
                      for r in per_layer)
        out["compressed_bytes"] = total_c
        out["reduction"] = 1.0 - total_c / total_fp32
        out["bits_per_layer"] = [r.get("bits") for r in per_layer]
        full_saved = total_c
    if n_parts > 1:
        if batch_nodes is None:
            batch_nodes = _bucket(-(-g.n_nodes // n_parts), node_multiple)
        rows_b = saved_bytes_per_layer(cfg, g.n_feats, batch_nodes)
        peak_fp32 = sum(r["fp32_bytes"] for r in rows_b)
        peak = (sum(r.get("compressed_bytes", r["fp32_bytes"])
                    for r in rows_b) if has_comp else peak_fp32)
        key = "mesh" if mesh_kind else "batched"
        out[key] = {
            "n_parts": n_parts, "batch_nodes": batch_nodes,
            "peak_fp32_bytes": peak_fp32, "peak_saved_bytes": peak,
            "full_graph_saved_bytes": full_saved,
            "peak_reduction_vs_full": full_saved / peak,
            "per_layer": rows_b,
        }
        if mesh_kind:
            # the per-rank ledger: the halo strip stashes nothing
            out[key]["per_device_saved_bytes"] = peak
    if plan.offload is not None:
        # an explicit batch_nodes wins even at n_parts == 1: the batched
        # engine pads its single batch, and the ledger describes the plan
        # training lays out
        stash_nodes = batch_nodes if batch_nodes is not None else g.n_nodes
        arena_plan = plan_gnn_stashes(cfg, g.n_feats, stash_nodes)
        stats = device_memory_stats()
        out["arena"] = {
            "policy": plan.offload,
            "stash_nodes": stash_nodes,
            "planned_bytes": arena_plan.total_bytes,
            "u32_bytes": arena_plan.u32_bytes,
            "f32_bytes": arena_plan.f32_bytes,
            "per_layer": arena_plan.per_layer_rows(),
            "device_resident_bytes":
                device_resident_stash_bytes(arena_plan, plan.offload),
            "measured_live_bytes": measure_live_bytes(),
            "device_peak_bytes":
                stats.get("peak_bytes_in_use") if stats else None,
        }
    return out
