"""The engine's training steps (the reference's ``engine/compile.py``):
:func:`compile_plan` lowers an :class:`~repro_torch.engine.plan.ExecutionPlan`
to :class:`CompiledFull` (one optimizer update per epoch on the full graph),
:class:`CompiledPartition` (the padded subgraph batches, one update per
``dp * grad_accum`` batches, ``dp`` ranks of a process group each taking
its share), both on the engine's stash-aware forward, or
:class:`CompiledMesh` (partitions trained ``m`` at a time on ``m`` ranks
with a halo exchange, on the per-op compressed stack).  PyTorch
runs eagerly, so "compiling" a plan here is building the step's state once:
the reference's one jitted ``lax.scan`` epoch becomes a Python loop over
the same batches in the same order with the same seeds.  The reference's
``engine/forward_builds`` counter counts forward traces; the port traces
none, so it counts each build of a step for a config (the compile and every
``recompile``), on the active metrics registry.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.engine import seeds
from repro_torch.engine.forward import (mesh_gnn_forward, stash_gnn_forward,
                                        stash_nbytes)
from repro_torch.engine.plan import ExecutionPlan, StashPolicy
from repro_torch.graph.models import GNN, DeviceGraph, GNNConfig, device_graph
from repro_torch.graph.sampling import make_subgraph_batches
from repro_torch.kernels.autotune import StepTiles
from repro_torch.obs.metrics import get_metrics
from repro_torch.obs.session import NULL_SESSION
from repro_torch.offload.engine import ArenaStore
from repro_torch.offload.gnn import plan_gnn_stashes
from repro_torch.offload.pager import FeaturePager
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel.halo import (build_halo_program, dp_size,
                                       exchange_widths, graph_mesh,
                                       group_rank, halo_bytes_per_epoch,
                                       rank_round)


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean masked softmax cross-entropy."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)


def _sum_over(group, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """``tensors`` summed over the ranks of ``group`` (one ``all_reduce`` of
    their concatenation; as they are for a world of one rank)."""
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _built() -> StepTiles:
    """Count one build of a step for a config (``engine/forward_builds``);
    returns the build's table of fused-pair tiles (each shape resolved on
    its first launch, as the reference resolves them at trace time)."""
    get_metrics().counter("engine/forward_builds").inc()
    return StepTiles()


def _arena_store(stash: StashPolicy, cfg: GNNConfig, graph: DeviceGraph):
    """The :class:`~repro_torch.offload.engine.ArenaStore` of an arena
    stash policy, planned for ``cfg`` over ``graph``'s rows (the full
    graph, or one padded batch: every batch has its shape); None for
    per-tensor stashes."""
    if stash.kind == "tensor":
        return None
    n_nodes, in_dim = graph.features.shape
    return ArenaStore(plan_gnn_stashes(cfg, in_dim, n_nodes),
                      stash.placement, graph.features.device)


class CompiledFull:
    """Full-graph step: ``step(epoch)`` runs forward, the manual backward
    and AdamW in place, and returns the loss (a device scalar).  ``fused``
    is the reference's ``KernelPolicy.fused`` knob ("auto" | "on" | "off")
    for the matmul-quant pair; an arena ``stash`` policy plans its
    :class:`~repro_torch.offload.arena.StashPlan` once, over the graph."""

    def __init__(self, graph: DeviceGraph, cfg: GNNConfig, model: GNN,
                 opt: AdamWConfig, fused: str = "auto",
                 stash: StashPolicy = StashPolicy()):
        self.graph, self.cfg, self.model, self.opt = graph, cfg, model, opt
        self.fused, self.stash = fused, stash
        self.store = _arena_store(stash, cfg, graph)
        self.state = adamw_init(model.flat_params(), opt)
        self.stash_bytes: list[int] = []
        self.tiles = _built()

    def recompile(self, cfg: GNNConfig) -> "CompiledFull":
        """The autoprec refresh hook: new widths (and a new stash plan for
        them), the same model, optimizer state and graph."""
        self.cfg = cfg
        self.store = _arena_store(self.stash, cfg, self.graph)
        self.tiles = _built()
        return self

    def step(self, epoch: int) -> torch.Tensor:
        params = self.model.flat_params()
        with self.tiles:
            logits = stash_gnn_forward(self.model, self.graph, self.cfg,
                                       seeds.sr_seed(epoch), self.fused,
                                       self.store)
            self.stash_bytes = stash_nbytes(logits)
            loss = masked_nll(logits, self.graph.labels,
                              self.graph.train_mask)
            grads = torch.autograd.grad(loss, params)
        adamw_update(grads, self.state, params, self.opt)
        return loss.detach()

    def epoch_data(self, order_rng) -> tuple:
        """What :meth:`step` takes after the epoch: nothing."""
        return ()

    def calibration(self) -> DeviceGraph:
        """The graph autoprec calibrates on: the full graph."""
        return self.graph

    def result_extras(self) -> dict:
        return {} if self.store is None else {"arena": self.store.stats()}


class CompiledPartition:
    """Partition-sampled step (the reference's ``_CompiledPartition``):
    ``step(epoch, order)`` walks the padded batches in ``order``, ``dp *
    grad_accum`` of them an optimizer update, and returns the mean of the
    updates' losses (a device scalar; nothing is read back inside the
    epoch).  With ``mesh`` a process group of ``dp`` ranks, rank ``i`` runs
    position ``u * dp * grad_accum + a * dp + i`` of update ``u`` (micro
    step ``a``) with the SR seed of its ordinal ``epoch * n_parts +
    position``; each rank sums its gradients from zeros, the sums are added
    over the ranks, divided by the tensor ``dp * grad_accum``, and every
    rank takes the same AdamW update.  So ``dp`` ranks at ``grad_accum=1``
    are one process at ``grad_accum=dp`` bit for bit when ``dp`` is 2 (a
    two-term sum).  Each batch is moved to the device once, here; the last
    forward's live stash is ``stash_bytes``.  An arena stash policy plans
    its :class:`~repro_torch.offload.arena.StashPlan` once, over the padded
    batch's rows; its host placements need ``dp == 1``."""

    def __init__(self, g, cfg: GNNConfig, plan: ExecutionPlan, model: GNN,
                 opt: AdamWConfig, device, batches=None, seed: int = 0,
                 mesh=None):
        sp = plan.sampling
        if batches is None:
            batches = make_subgraph_batches(
                g, sp.n_parts, method=sp.method, halo=sp.halo, seed=seed,
                node_multiple=sp.node_multiple,
                edge_multiple=sp.edge_multiple, renormalize=sp.renormalize)
        elif len(batches) != sp.n_parts:
            raise ValueError(f"prebuilt batches list has {len(batches)} "
                             f"entries but n_parts={sp.n_parts}")
        self.n_batches = len(batches)
        self.group, self.dp, self.rank = mesh, dp_size(mesh), group_rank(mesh)
        if plan.stash.offload in ("host", "pinned-paged") and self.dp > 1:
            raise ValueError(
                f"offload={plan.stash.offload!r} needs an unsharded run "
                f"(dp_size==1); got dp={self.dp}")
        self.grad_accum = sp.grad_accum
        self.per_update = self.dp * self.grad_accum
        if self.n_batches % self.per_update:
            raise ValueError(
                f"n_parts={self.n_batches} must be a multiple of "
                f"dp*grad_accum={self.dp}*{self.grad_accum}="
                f"{self.per_update} (whole update groups per epoch)")
        self.n_updates = self.n_batches // self.per_update
        self.cfg, self.model, self.opt = cfg, model, opt
        self.fused = plan.kernel.fused
        self.batch_nodes = batches[0].n_nodes
        self.batch_edges = batches[0].n_edges
        self.graphs = [device_graph(b, cfg.arch, device) for b in batches]
        self.stash = plan.stash
        self.store = _arena_store(plan.stash, cfg, self.graphs[0])
        self.reshuffle = sp.shuffle and self.n_batches > 1
        self.state = adamw_init(model.flat_params(), opt)
        self._accum = torch.tensor(float(self.per_update), device=device)
        self.stash_bytes: list[int] = []
        self.tiles = _built()

    def recompile(self, cfg: GNNConfig) -> "CompiledPartition":
        """The autoprec refresh hook: new widths (and a new stash plan for
        them), the same batches."""
        self.cfg = cfg
        self.store = _arena_store(self.stash, cfg, self.graphs[0])
        self.tiles = _built()
        return self

    def epoch_data(self, order_rng: np.random.Generator) -> tuple:
        """The epoch's batch order: one draw of ``order_rng`` when
        shuffling more than one batch, else the batches in turn."""
        if not self.reshuffle:
            return (range(self.n_batches),)
        return (order_rng.permutation(self.n_batches),)

    def _micro(self, graph: DeviceGraph, seed: int):
        with self.tiles:
            logits = stash_gnn_forward(self.model, graph, self.cfg, seed,
                                       self.fused, self.store)
            self.stash_bytes = stash_nbytes(logits)
            loss = masked_nll(logits, graph.labels, graph.train_mask)
            return loss, torch.autograd.grad(loss, self.model.flat_params())

    def step(self, epoch: int, order) -> torch.Tensor:
        params = self.model.flat_params()
        order = list(order)
        dp, rank, per = self.dp, self.rank, self.per_update
        losses = []
        for u in range(self.n_updates):
            gsum = [torch.zeros_like(p) for p in params]
            micro = []
            for a in range(self.grad_accum):
                ordinal = seeds.batch_ordinals(epoch, self.n_batches, u, per,
                                               a, dp)[rank]
                loss, grads = self._micro(
                    self.graphs[order[u * per + a * dp + rank]],
                    seeds.sr_seed(ordinal))
                for s, gr in zip(gsum, grads):
                    s.add_(gr)
                micro.append(loss.detach())
            if dp > 1:
                # every rank's micro losses at their positions (the rest
                # zero, so the sum over ranks places each one exactly)
                placed = torch.zeros(per, device=micro[0].device)
                placed[rank::dp] = torch.stack(micro)
                gsum = _sum_over(self.group, gsum + [placed])
                micro = [gsum.pop()]
            # a tensor divisor: CUDA turns `t / python_scalar` into a
            # multiply by its reciprocal
            adamw_update([s / self._accum for s in gsum], self.state, params,
                         self.opt)
            losses.append(torch.cat([m.reshape(-1) for m in micro]).mean())
        return torch.stack(losses).mean()

    def calibration(self) -> DeviceGraph:
        """One padded batch, the engine's live stash unit, node mask
        included: autoprec's byte ceiling is then per batch."""
        return self.graphs[0]

    def result_extras(self) -> dict:
        extras = {"n_parts": self.n_batches,
                  "updates_per_epoch": self.n_updates,
                  "batch_nodes": self.batch_nodes,
                  "batch_edges": self.batch_edges}
        if self.store is not None:
            extras["arena"] = self.store.stats()
        return extras


class CompiledMesh:
    """Mesh-sharded step (the reference's ``_CompiledMesh``): the plan's
    ``n_parts`` partitions on the ``m`` ranks of the process group ``mesh``
    (:func:`~repro_torch.parallel.halo.graph_mesh`), trained ``m`` at a time
    in ``n_parts // m`` rounds with a halo exchange before every
    aggregation; each rank's features stay in host memory behind a
    :class:`~repro_torch.offload.pager.FeaturePager` that copies the next
    round's pages while this round computes.

    One update a round: rank ``i`` trains partition ``r * m + i`` with the
    SR seed of ordinal ``epoch * n_parts + r * m + i``.  The loss is
    round-global: the train-mask count ``den`` is summed over the ranks
    (no gradient), each rank backpropagates its ``sum(nll * mask) /
    max(den, 1)``, the gradients (summed from zeros) are added over the
    ranks, and every rank takes the same AdamW update.  So ``m == n_parts``
    is the full-graph loss, and ``m == 1`` is :class:`CompiledPartition`
    with ``shuffle=False`` bit for bit.

    ``obs`` (the run's :class:`~repro_torch.obs.session.ObsSession`) gets a
    ``mesh/round`` span a round with ``pager/fetch`` inside it, each round's
    bytes sent added to the ``halo/bytes`` counter, and the pager's
    counters and overlap histogram in its registry."""

    def __init__(self, g, cfg: GNNConfig, plan: ExecutionPlan, model: GNN,
                 opt: AdamWConfig, device, batches=None, seed: int = 0,
                 mesh=None, obs=NULL_SESSION):
        sp = plan.sampling
        if batches is not None:
            raise ValueError("mesh sampling builds its own partition "
                             "layout; prebuilt batches are a partition-"
                             "plan resource")
        if plan.stash.kind != "tensor":
            raise ValueError("mesh sampling stashes per-tensor residuals "
                             "on each device (the features are what is "
                             f"host-resident); stash kind "
                             f"{plan.stash.kind!r} is unsupported")
        if plan.precision.kind != "fixed":
            raise ValueError("mesh sampling does not support autoprec "
                             "(calibrate on a partition plan and pass the "
                             "allocated cfg)")
        if plan.kernel.fused == "on":
            raise ValueError("mesh sampling composes the per-op compressed "
                             "stack; fused='on' is unsupported (use "
                             "'auto'/'off')")
        self.group = graph_mesh(sp.n_parts, mesh)
        self.m, self.rank = dp_size(self.group), group_rank(self.group)
        self.n_parts = sp.n_parts
        self.cfg, self.model, self.opt = cfg, model, opt
        self.in_dim = g.n_feats
        self.prog = build_halo_program(
            g, sp.n_parts, self.m, method=sp.method, seed=seed,
            node_multiple=sp.node_multiple, edge_multiple=sp.edge_multiple)
        self.rounds = self.prog.rounds
        self.tables = [rank_round(self.prog, r, self.rank, cfg.arch, device)
                       for r in range(self.rounds)]
        self.obs = obs
        self.pager = FeaturePager(self.prog.features, device, rank=self.rank,
                                  metrics=obs.registry)
        self.pager.prefetch(0)
        self._halo_ctr = obs.counter("halo/bytes")
        self.state = adamw_init(model.flat_params(), opt)
        self.stash_bytes: list[int] = []
        self.halo_bytes_sent = 0
        _built()

    def round(self, epoch: int, r: int) -> torch.Tensor:
        """Round ``r`` of ``epoch``: fetch its features, queue the next
        round's (the next epoch's first after the last), train and update;
        returns the round-global loss (a device scalar)."""
        with self.obs.span("mesh/round", round=r):
            params = self.model.flat_params()
            m, rank, group = self.m, self.rank, self.group
            with self.obs.span("pager/fetch", round=r):
                feats = self.pager.fetch(r)
            self.pager.prefetch((r + 1) % self.rounds)
            t = self.tables[r]
            ordinal = seeds.batch_ordinals(epoch, self.n_parts, r, m, 0,
                                           m)[rank]
            logits, self.stash_bytes, sent = mesh_gnn_forward(
                self.model, feats, t, self.cfg, seed=seeds.sr_seed(ordinal),
                group=group)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(1, t.labels[:, None])[:, 0]
            num = torch.sum(nll * t.train_mask)
            den, shown = t.train_mask.sum(), num.detach()
            if group is not None:
                # the train-mask count and the shown loss's numerator, summed
                # over the ranks in one collective
                shown, den = _sum_over(group, [torch.stack([shown, den])])[0]
            loss = num / torch.clamp(den, min=1)
            grads = torch.autograd.grad(loss, params)
            gsum = _sum_over(group, [torch.zeros_like(p).add_(gr)
                                     for p, gr in zip(params, grads)])
            adamw_update(gsum, self.state, params, self.opt)
            self.halo_bytes_sent += sent
            self._halo_ctr.inc(sent)
            return shown / torch.clamp(den, min=1)

    def step(self, epoch: int) -> torch.Tensor:
        """Every round of ``epoch`` in order; the mean of their losses."""
        return torch.stack([self.round(epoch, r)
                            for r in range(self.rounds)]).mean()

    def epoch_data(self, order_rng) -> tuple:
        """What :meth:`step` takes after the epoch: nothing (static round
        order)."""
        return ()

    def calibration(self):
        raise ValueError("mesh sampling does not support autoprec "
                         "calibration")

    def result_extras(self) -> dict:
        dims = [self.in_dim, *self.cfg.hidden, self.cfg.n_classes]
        widths = exchange_widths(self.cfg.arch, dims)
        return {"n_parts": self.n_parts,
                "mesh_devices": self.m,
                "updates_per_epoch": self.rounds,
                "batch_nodes": self.prog.n_pad,
                "batch_edges": self.prog.e_pad,
                "halo_width": self.prog.halo,
                "halo_edges": self.prog.halo_edges,
                "dropped_edges": self.prog.dropped_edges,
                "halo_bytes_per_epoch": halo_bytes_per_epoch(self.prog,
                                                             widths),
                "halo_bytes_sent": self.halo_bytes_sent,
                "rank": self.rank,
                "pager": self.pager.stats()}


def compile_plan(g, cfg: GNNConfig, plan: ExecutionPlan, model: GNN,
                 opt: AdamWConfig, device, *, batches=None, mesh=None,
                 seed: int = 0, obs=NULL_SESSION):
    """Lower ``plan`` for graph ``g`` on ``device``, training ``model`` in
    place: a :class:`CompiledFull`, :class:`CompiledPartition` or
    :class:`CompiledMesh`, each with ``step``, ``epoch_data``,
    ``calibration`` and ``result_extras``, and the first two with
    ``recompile`` (the autoprec refresh hook; a mesh plan runs no
    autoprec).  ``batches`` (a prebuilt
    :func:`~repro_torch.graph.sampling.make_subgraph_batches` list) skips
    partitioning for a partition plan; ``mesh`` (a process group) spreads a
    partition plan's batches over its ranks (data parallel) and is the
    group a mesh plan trains on (None: the default group if
    ``torch.distributed`` is initialized, else one rank).  ``obs`` is the
    run's :class:`~repro_torch.obs.session.ObsSession`: the mesh lowering
    threads it into its round spans, the pager's registry and the halo byte
    counter (the default null session makes all of that free)."""
    kind = plan.sampling.kind
    if kind == "full":
        if batches is not None:
            raise ValueError("prebuilt batches need partition sampling")
        return CompiledFull(device_graph(g, cfg.arch, device), cfg, model,
                            opt, plan.kernel.fused, plan.stash)
    if kind == "mesh":
        return CompiledMesh(g, cfg, plan, model, opt, device, batches, seed,
                            mesh, obs)
    return CompiledPartition(g, cfg, plan, model, opt, device, batches, seed,
                             mesh)
