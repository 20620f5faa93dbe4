"""GNN training entry point: full-graph training (the paper's Table 1 loop)
over the engine (:mod:`repro_torch.engine.runner`)."""
from __future__ import annotations

from repro_torch.engine.runner import run
from repro_torch.graph.data import Graph
from repro_torch.graph.models import GNN, GNNConfig
from repro_torch.optim import AdamWConfig


def train_gnn(g: Graph, cfg: GNNConfig, opt: AdamWConfig | None = None,
              n_epochs: int = 100, seed: int = 0, params: GNN | None = None,
              impl: str = "auto", fused: str = "auto",
              device="cuda") -> dict:
    """Full-graph training; returns dict(test_acc, val_acc, history,
    epochs_per_sec, model, stash_bytes) (see
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
    rows, whole blocks) and runs the two-pass spelling elsewhere, "on"
    forces the pair (the plain composition on the CPU, the same bits) and
    raises on an ineligible layer, "off" never fuses.
    """
    return run(g, cfg.with_impl(impl), opt, n_epochs=n_epochs, seed=seed,
               params=params, device=device, fused=fused)
