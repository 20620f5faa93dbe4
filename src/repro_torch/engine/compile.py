"""The engine's training steps (the reference's ``engine/compile.py``):
:func:`compile_plan` lowers an :class:`~repro_torch.engine.plan.ExecutionPlan`
to :class:`CompiledFull` (one optimizer update per epoch on the full graph)
or :class:`CompiledPartition` (the padded subgraph batches, one update per
``grad_accum`` batches), both on the engine's stash-aware forward.  PyTorch
runs eagerly, so "compiling" a plan here is building the step's state once:
the reference's one jitted ``lax.scan`` epoch becomes a Python loop over
the same batches in the same order with the same seeds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine import seeds
from repro_torch.engine.forward import stash_gnn_forward, stash_nbytes
from repro_torch.engine.plan import ExecutionPlan, StashPolicy
from repro_torch.graph.models import GNN, DeviceGraph, GNNConfig, device_graph
from repro_torch.graph.sampling import make_subgraph_batches
from repro_torch.offload.engine import ArenaStore
from repro_torch.offload.gnn import plan_gnn_stashes
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean masked softmax cross-entropy."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)


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

    def recompile(self, cfg: GNNConfig) -> "CompiledFull":
        """The autoprec refresh hook: new widths (and a new stash plan for
        them), the same model, optimizer state and graph."""
        self.cfg = cfg
        self.store = _arena_store(self.stash, cfg, self.graph)
        return self

    def step(self, epoch: int) -> torch.Tensor:
        params = self.model.flat_params()
        logits = stash_gnn_forward(self.model, self.graph, self.cfg,
                                   seeds.sr_seed(epoch), self.fused,
                                   self.store)
        self.stash_bytes = stash_nbytes(logits)
        loss = masked_nll(logits, self.graph.labels, self.graph.train_mask)
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
    """Partition-sampled step (the reference's ``_CompiledPartition``,
    without the data-parallel axis: ``dp`` is 1): ``step(epoch, order)``
    walks the padded batches in ``order``, ``grad_accum`` of them an
    optimizer update (gradients summed from zeros, divided by
    ``grad_accum``, then one AdamW update), each batch with the SR seed of
    its ordinal ``epoch * n_parts + position``, and returns the mean of the
    updates' losses (a device scalar; nothing is read back inside the
    epoch).  Each batch is moved to the device once, here; the last
    forward's live stash is ``stash_bytes``.  An arena stash policy plans
    its :class:`~repro_torch.offload.arena.StashPlan` once, over the padded
    batch's rows."""

    def __init__(self, g, cfg: GNNConfig, plan: ExecutionPlan, model: GNN,
                 opt: AdamWConfig, device, batches=None, seed: int = 0):
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
        self.grad_accum = sp.grad_accum
        if self.n_batches % self.grad_accum:
            raise ValueError(
                f"n_parts={self.n_batches} must be a multiple of "
                f"dp*grad_accum=1*{self.grad_accum}={self.grad_accum} "
                f"(whole update groups per epoch)")
        self.n_updates = self.n_batches // self.grad_accum
        self.cfg, self.model, self.opt = cfg, model, opt
        self.fused = plan.kernel.fused
        self.batch_nodes = batches[0].n_nodes
        self.batch_edges = batches[0].n_edges
        self.graphs = [device_graph(b, cfg.arch, device) for b in batches]
        self.stash = plan.stash
        self.store = _arena_store(plan.stash, cfg, self.graphs[0])
        self.reshuffle = sp.shuffle and self.n_batches > 1
        self.state = adamw_init(model.flat_params(), opt)
        self._accum = torch.tensor(float(self.grad_accum), device=device)
        self.stash_bytes: list[int] = []

    def recompile(self, cfg: GNNConfig) -> "CompiledPartition":
        """The autoprec refresh hook: new widths (and a new stash plan for
        them), the same batches."""
        self.cfg = cfg
        self.store = _arena_store(self.stash, cfg, self.graphs[0])
        return self

    def epoch_data(self, order_rng: np.random.Generator) -> tuple:
        """The epoch's batch order: one draw of ``order_rng`` when
        shuffling more than one batch, else the batches in turn."""
        if not self.reshuffle:
            return (range(self.n_batches),)
        return (order_rng.permutation(self.n_batches),)

    def _micro(self, graph: DeviceGraph, seed: int):
        logits = stash_gnn_forward(self.model, graph, self.cfg, seed,
                                   self.fused, self.store)
        self.stash_bytes = stash_nbytes(logits)
        loss = masked_nll(logits, graph.labels, graph.train_mask)
        return loss, torch.autograd.grad(loss, self.model.flat_params())

    def step(self, epoch: int, order) -> torch.Tensor:
        params = self.model.flat_params()
        order = list(order)
        losses = []
        for u in range(self.n_updates):
            gsum = [torch.zeros_like(p) for p in params]
            micro = []
            for a in range(self.grad_accum):
                (ordinal,) = seeds.batch_ordinals(
                    epoch, self.n_batches, u, self.grad_accum, a, 1)
                loss, grads = self._micro(
                    self.graphs[order[u * self.grad_accum + a]],
                    seeds.sr_seed(ordinal))
                for s, gr in zip(gsum, grads):
                    s.add_(gr)
                micro.append(loss.detach())
            # a tensor divisor: CUDA turns `t / python_scalar` into a
            # multiply by its reciprocal
            adamw_update([s / self._accum for s in gsum], self.state, params,
                         self.opt)
            losses.append(torch.stack(micro).mean())
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


def compile_plan(g, cfg: GNNConfig, plan: ExecutionPlan, model: GNN,
                 opt: AdamWConfig, device, *, batches=None, seed: int = 0):
    """Lower ``plan`` for graph ``g`` on ``device``, training ``model`` in
    place: a :class:`CompiledFull` or a :class:`CompiledPartition`, each
    with ``step``, ``epoch_data``, ``recompile`` (the autoprec refresh
    hook), ``calibration`` and ``result_extras``.  ``batches`` (a prebuilt
    :func:`~repro_torch.graph.sampling.make_subgraph_batches` list) skips
    partitioning for a partition plan."""
    if plan.sampling.kind == "full":
        if batches is not None:
            raise ValueError("prebuilt batches need partition sampling")
        return CompiledFull(device_graph(g, cfg.arch, device), cfg, model,
                            opt, plan.kernel.fused, plan.stash)
    return CompiledPartition(g, cfg, plan, model, opt, device, batches, seed)
