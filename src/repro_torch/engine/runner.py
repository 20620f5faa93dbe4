"""The epoch loop behind :func:`repro_torch.graph.train.train_gnn` and
:func:`~repro_torch.graph.train.train_gnn_batched` (the reference's
``engine/runner.py``): it compiles the plan, asks the compiled step for
each epoch's data, runs the step, and services the autoprec refresh as a
recompile hook.  Everything policy-shaped lives in the plan and its
compiler.

Observability (the plan's :class:`~repro_torch.obs.policy.ObsPolicy`)
wraps the loop from the outside: host-time spans around the plan compile,
epochs, autoprec re-solves and recompiles, a recompile counter, and the
opt-in quant-health probe on its epoch cadence.  None of it writes what the
step reads, so obs-on runs are bit-identical to obs-off."""
from __future__ import annotations

import copy

import torch

from repro_torch.core.device import resolve_device
from repro_torch.engine import seeds
from repro_torch.engine.compile import compile_plan
from repro_torch.engine.plan import ExecutionPlan
from repro_torch.engine.precision import AutoprecController
from repro_torch.graph.models import GNN, GNNConfig, device_graph
from repro_torch.obs.session import ObsSession
from repro_torch.obs.trace import stopwatch
from repro_torch.optim import AdamWConfig


@torch.no_grad()
def _accuracy(model: GNN, graph, mask: torch.Tensor) -> float:
    logits = model(graph)
    correct = (logits.argmax(-1) == graph.labels).to(torch.float32)
    return float(torch.sum(correct * mask) / torch.clamp(mask.sum(), min=1))


def _probe_graph(compiled, g, arch: str, device):
    """The graph the quant-health probe runs on: the plan's calibration
    unit (one padded batch for a partition plan, the full graph otherwise),
    or for a mesh plan, which has no calibration unit, the full graph (a
    measurement pass, not a training stash)."""
    try:
        return compiled.calibration()
    except ValueError:
        return device_graph(g, arch, device)


def run(g, cfg: GNNConfig, plan: ExecutionPlan | None = None,
        opt: AdamWConfig | None = None, *, n_epochs: int = 100,
        seed: int = 0, params: GNN | None = None, device="cuda",
        batches=None, mesh=None) -> dict:
    """Train ``cfg`` on ``g`` under ``plan`` (default: full graph, fixed
    precision); returns ``test_acc``, ``val_acc`` (full graph, final
    weights), ``history`` (one ``(epoch, loss, ms)`` per epoch: the epoch's
    mean loss over its updates, and the host time from its data through the
    loss read-back), ``epochs_per_sec``, ``model`` (the trained
    :class:`GNN`; ``params`` itself is left untouched), ``stash_bytes``
    (the last forward's live stash, per layer), ``cfg`` (the config the
    last step ran) and ``plan``; a partition plan adds ``n_parts``,
    ``updates_per_epoch``, ``batch_nodes`` and ``batch_edges``, and an
    arena stash policy ``arena`` (the plan's bytes and the readers' gauges:
    :meth:`repro_torch.offload.engine.ArenaStore.stats`), and a mesh plan
    the mesh extras (``CompiledMesh.result_extras``).  ``batches``
    (prebuilt subgraph batches) skips a partition plan's sampling pass.
    ``mesh`` is a ``torch.distributed`` process group: a partition plan's
    batches are spread over its ranks (data parallel), a mesh plan's
    partitions trained on them; every rank calls ``run`` alike and ends
    with the same model, evaluated on the full graph.

    Autoprec (``plan.precision.kind == "autoprec"``) runs in the
    reference's order: allocate on the compiled step's calibration unit and
    recompile before epoch 0, re-solve when ``due(epoch)``, recompile only
    when the widths changed; the result then also holds ``bits_per_layer``
    and ``bit_budget_bytes``.  An epoch's ``ms`` excludes its re-solve and
    the quant-health probe; ``epochs_per_sec`` counts the whole loop.

    An enabled ``plan.obs`` adds the live
    :class:`~repro_torch.obs.session.ObsSession` under ``obs``: its spans,
    its metrics and, with ``quant_stats``, the probe's rows
    (``result["obs"].quant_rows()``).  ``calibration="obs"`` needs
    ``ObsPolicy(enabled=True, quant_stats=True)`` (``ValueError``)."""
    plan = plan if plan is not None else ExecutionPlan()
    if (plan.precision.kind == "autoprec"
            and plan.precision.calibration == "obs"
            and not (plan.obs.enabled and plan.obs.quant_stats)):
        raise ValueError("precision.calibration='obs' sources sensitivities "
                         "from the quant-health telemetry channel; the plan "
                         "needs obs=ObsPolicy(enabled=True, "
                         "quant_stats=True)")
    obs = ObsSession.from_policy(plan.obs)
    device = resolve_device(device)
    opt = opt or AdamWConfig(lr=5e-3, weight_decay=0.0)
    cfg = plan.kernel.apply(cfg)
    if params is None:
        params = GNN(cfg, g.n_feats,
                     generator=torch.Generator().manual_seed(seed))
    model = copy.deepcopy(params).to(device)
    with obs.activate():
        with obs.span("plan/compile", plan=plan.describe()):
            compiled = compile_plan(g, cfg, plan, model, opt, device,
                                    batches=batches, mesh=mesh, seed=seed,
                                    obs=obs)
        probe_graph = None
        ctrl = None
        if plan.precision.kind == "autoprec":
            ctrl = AutoprecController(compiled.calibration(), cfg,
                                      plan.precision.bit_budget,
                                      plan.precision.refresh, seed,
                                      plan.precision.calibration)
            with obs.span("autoprec/solve", epoch=0):
                cfg, _ = ctrl.allocate(model)
            with obs.span("plan/recompile", epoch=0):
                compiled.recompile(cfg)
            obs.counter("engine/recompiles").inc()
        order_rng = seeds.order_rng(seed)
        history = []
        with stopwatch("train/epochs", epochs=n_epochs) as sw:
            for epoch in range(n_epochs):
                if ctrl is not None and ctrl.due(epoch):
                    with obs.span("autoprec/solve", epoch=epoch):
                        cfg, changed = ctrl.allocate(model)
                    if changed:
                        with obs.span("plan/recompile", epoch=epoch):
                            compiled.recompile(cfg)
                        obs.counter("engine/recompiles").inc()
                # the loss read-back makes this span wait for the device
                with stopwatch("epoch", epoch=epoch) as ep:
                    loss = float(compiled.step(
                        epoch, *compiled.epoch_data(order_rng)))
                history.append((epoch, loss, ep.elapsed_s * 1e3))
                if obs.quant_due(epoch):
                    with obs.span("obs/quant_probe", epoch=epoch):
                        if probe_graph is None:
                            probe_graph = _probe_graph(compiled, g, cfg.arch,
                                                       device)
                        obs.quant_probe(model, probe_graph, epoch, cfg)
        extra = ctrl.extras() if ctrl is not None else {}
        extra.update(compiled.result_extras())
    if obs.enabled:
        extra["obs"] = obs
    graph = (compiled.graph if plan.sampling.kind == "full"
             else device_graph(g, cfg.arch, device))
    return {"test_acc": _accuracy(model, graph, graph.test_mask),
            "val_acc": _accuracy(model, graph, graph.val_mask),
            "history": history, "epochs_per_sec": n_epochs / sw.elapsed_s,
            "model": model, "stash_bytes": compiled.stash_bytes, "cfg": cfg,
            "plan": plan, **extra}
