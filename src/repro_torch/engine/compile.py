"""The full-graph training step (the reference's ``engine/compile.py``,
``_CompiledFull``): one optimizer update per epoch on the engine's
stash-aware forward.  PyTorch runs eagerly, so "compiling" a plan here is
building the step's state once."""
from __future__ import annotations

import torch

from repro_torch.engine import seeds
from repro_torch.engine.forward import stash_gnn_forward, stash_nbytes
from repro_torch.graph.models import GNN, DeviceGraph, GNNConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean masked softmax cross-entropy."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)


class CompiledFull:
    """Full-graph step: ``step(epoch)`` runs forward, the manual backward
    and AdamW in place, and returns the loss (a device scalar).  ``fused``
    is the reference's ``KernelPolicy.fused`` knob ("auto" | "on" | "off")
    for the matmul-quant pair."""

    def __init__(self, graph: DeviceGraph, cfg: GNNConfig, model: GNN,
                 opt: AdamWConfig, fused: str = "auto"):
        self.graph, self.cfg, self.model, self.opt = graph, cfg, model, opt
        self.fused = fused
        self.state = adamw_init(model.flat_params(), opt)
        self.stash_bytes: list[int] = []

    def recompile(self, cfg: GNNConfig) -> "CompiledFull":
        """The autoprec refresh hook: new widths, the same model, optimizer
        state and graph."""
        self.cfg = cfg
        return self

    def step(self, epoch: int) -> torch.Tensor:
        params = self.model.flat_params()
        logits = stash_gnn_forward(self.model, self.graph, self.cfg,
                                   seeds.sr_seed(epoch), self.fused)
        self.stash_bytes = stash_nbytes(logits)
        loss = masked_nll(logits, self.graph.labels, self.graph.train_mask)
        grads = torch.autograd.grad(loss, params)
        adamw_update(grads, self.state, params, self.opt)
        return loss.detach()
