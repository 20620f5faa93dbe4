"""The epoch loop behind :func:`repro_torch.graph.train.train_gnn`
(the reference's ``engine/runner.py``, full-graph sampling, at fixed
precision or under autoprec)."""
from __future__ import annotations

import copy
import time

import torch

from repro_torch.core.device import resolve_device
from repro_torch.engine.compile import CompiledFull
from repro_torch.engine.precision import AutoprecController
from repro_torch.graph.models import GNN, GNNConfig, device_graph
from repro_torch.optim import AdamWConfig


@torch.no_grad()
def _accuracy(model: GNN, graph, mask: torch.Tensor) -> float:
    logits = model(graph)
    correct = (logits.argmax(-1) == graph.labels).to(torch.float32)
    return float(torch.sum(correct * mask) / torch.clamp(mask.sum(), min=1))


def run(g, cfg: GNNConfig, opt: AdamWConfig | None = None, *,
        n_epochs: int = 100, seed: int = 0, params: GNN | None = None,
        device="cuda", fused: str = "auto", bit_budget: float | None = None,
        autoprec_refresh: int = 0) -> dict:
    """Train ``cfg`` on ``g``; returns ``test_acc``, ``val_acc``,
    ``history`` (one ``(epoch, loss, ms)`` per epoch, the host time of the
    step through the loss read-back), ``epochs_per_sec``, ``model`` (the
    trained :class:`GNN`; ``params`` itself is left untouched),
    ``stash_bytes`` (the last step's live stash, per layer) and ``cfg``
    (the config the last step ran).  ``fused`` routes the matmul-quant pair
    (see :class:`CompiledFull`).

    ``bit_budget`` turns on autoprec (:class:`AutoprecController`), in the
    reference's order: allocate and recompile before epoch 0, re-solve when
    ``due(epoch)`` (every ``autoprec_refresh`` epochs), recompile only when
    the widths changed.  The result then also holds ``bits_per_layer`` and
    ``bit_budget_bytes``.  An epoch's ``ms`` excludes its re-solve;
    ``epochs_per_sec`` counts the whole loop, re-solves included."""
    device = resolve_device(device)
    opt = opt or AdamWConfig(lr=5e-3, weight_decay=0.0)
    graph = device_graph(g, cfg.arch, device)
    if params is None:
        params = GNN(cfg, g.n_feats,
                     generator=torch.Generator().manual_seed(seed))
    model = copy.deepcopy(params).to(device)
    compiled = CompiledFull(graph, cfg, model, opt, fused)
    ctrl = None
    if bit_budget is not None:
        ctrl = AutoprecController(graph, cfg, bit_budget, autoprec_refresh,
                                  seed)
        cfg, _ = ctrl.allocate(model)
        compiled.recompile(cfg)
    history = []
    t_start = time.perf_counter()
    for epoch in range(n_epochs):
        if ctrl is not None and ctrl.due(epoch):
            cfg, changed = ctrl.allocate(model)
            if changed:
                compiled.recompile(cfg)
        t0 = time.perf_counter()
        loss = float(compiled.step(epoch))
        history.append((epoch, loss, (time.perf_counter() - t0) * 1e3))
    elapsed = time.perf_counter() - t_start
    extra = ctrl.extras() if ctrl is not None else {}
    return {"test_acc": _accuracy(model, graph, graph.test_mask),
            "val_acc": _accuracy(model, graph, graph.val_mask),
            "history": history, "epochs_per_sec": n_epochs / elapsed,
            "model": model, "stash_bytes": compiled.stash_bytes, "cfg": cfg,
            **extra}
