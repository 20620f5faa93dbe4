"""The epoch loop behind :func:`repro_torch.graph.train.train_gnn`
(the reference's ``engine/runner.py``, full-graph sampling at fixed
precision)."""
from __future__ import annotations

import copy
import time

import torch

from repro_torch.engine.compile import CompiledFull
from repro_torch.graph.models import GNN, GNNConfig, device_graph
from repro_torch.optim import AdamWConfig


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (the port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run the plain versions")
    return device


@torch.no_grad()
def _accuracy(model: GNN, graph, mask: torch.Tensor) -> float:
    logits = model(graph)
    correct = (logits.argmax(-1) == graph.labels).to(torch.float32)
    return float(torch.sum(correct * mask) / torch.clamp(mask.sum(), min=1))


def run(g, cfg: GNNConfig, opt: AdamWConfig | None = None, *,
        n_epochs: int = 100, seed: int = 0, params: GNN | None = None,
        device="cuda") -> dict:
    """Train ``cfg`` on ``g``; returns ``test_acc``, ``val_acc``,
    ``history`` (one ``(epoch, loss, ms)`` per epoch, the host time of the
    step through the loss read-back), ``epochs_per_sec``, ``model`` (the
    trained :class:`GNN`; ``params`` itself is left untouched) and
    ``stash_bytes`` (the last step's live stash, per layer)."""
    device = resolve_device(device)
    opt = opt or AdamWConfig(lr=5e-3, weight_decay=0.0)
    graph = device_graph(g, cfg.arch, device)
    if params is None:
        params = GNN(cfg, g.n_feats,
                     generator=torch.Generator().manual_seed(seed))
    model = copy.deepcopy(params).to(device)
    compiled = CompiledFull(graph, cfg, model, opt)
    history = []
    t_start = time.perf_counter()
    for epoch in range(n_epochs):
        t0 = time.perf_counter()
        loss = float(compiled.step(epoch))
        history.append((epoch, loss, (time.perf_counter() - t0) * 1e3))
    elapsed = time.perf_counter() - t_start
    return {"test_acc": _accuracy(model, graph, graph.test_mask),
            "val_acc": _accuracy(model, graph, graph.val_mask),
            "history": history, "epochs_per_sec": n_epochs / elapsed,
            "model": model, "stash_bytes": compiled.stash_bytes}
