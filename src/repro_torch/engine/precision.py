"""Autoprec's lifecycle: the variance-guided bit allocation behind
``train_gnn(bit_budget=...)`` and ``train_gnn_batched(bit_budget=...)``
(the reference's ``repro.engine.precision``).

Owns the budget (frozen on the first allocation, so refreshes re-split the
same byte ceiling), the current per-layer widths and the refresh cadence.
The run loop asks :meth:`AutoprecController.due` each epoch and, when an
:meth:`allocate` changes the widths, recompiles the step (the compiled
plan's ``recompile``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import autoprec
from repro_torch.engine import seeds
from repro_torch.engine.compile import masked_nll
from repro_torch.engine.forward import stash_gnn_forward
from repro_torch.engine.plan import CALIBRATION_KINDS
from repro_torch.graph.analysis import collect_layer_stats
from repro_torch.graph.models import GNN, DeviceGraph, GNNConfig
from repro_torch.obs.quantstats import (measure_quant_health,
                                        measured_sensitivity)


class AutoprecController:
    """Variance-guided bit allocation on the plan's calibration unit
    (``graph``): the full graph, or for the partition engine one padded
    batch, so the byte ceiling is per batch, the engine's live stash.

    ``allocate`` runs the cheap stats pass
    (:func:`repro_torch.graph.analysis.collect_layer_stats`) and calibrates
    each layer's ``grad_sens`` with a two-seed gradient probe: ``dx`` and
    the ReLU mask are free of SR noise, so ``dw_l(s1) - dw_l(s2)`` isolates
    exactly the dequantization noise layer l's stash injects.  The probe is
    the port's stash forward and manual backward with ``fused="off"``: the
    same ``dw = x_hat^T g`` as the reference's per-op probe, with a padded
    batch's node mask.  The stats pass reads no node mask, as the
    reference's does not.

    ``calibration="obs"`` replaces the gradient probe with the quant-health
    probe (:mod:`repro_torch.obs.quantstats`): the *measured* SR
    dequantization variance of each layer's stash at the template widths,
    divided by the same bit-scaling curve.  One pass through the RP and
    quant kernels instead of two forward and backward passes, and the
    sensitivity is the statistic the run-time monitor reports beside the
    Eq. 10 prediction.
    """

    def __init__(self, graph: DeviceGraph, cfg: GNNConfig, bit_budget: float,
                 refresh: int, seed: int, calibration: str = "probe"):
        if calibration not in CALIBRATION_KINDS:
            raise ValueError(f"calibration={calibration!r} not in "
                             f"{CALIBRATION_KINDS}")
        self.templates = cfg.layer_compression()
        if all(c is None for c in self.templates):
            raise ValueError(
                "bit_budget= needs a GNNConfig with compression configured")
        self.graph = graph
        self.base_cfg = cfg
        self.bit_budget = float(bit_budget)
        self.refresh = int(refresh)
        self.seed = seed
        self.calibration = calibration
        self.budget_bytes: int | None = None
        self.bits: tuple[int, ...] | None = None

    def _probe_dw(self, model: GNN, seed: int) -> list[torch.Tensor]:
        """Every layer's weight gradient at the template widths under the
        SR seed ``seed``."""
        g = self.graph
        with torch.enable_grad():
            logits = stash_gnn_forward(model, g, self.base_cfg, seed, "off")
            loss = masked_nll(logits, g.labels, g.train_mask)
            return list(torch.autograd.grad(loss, list(model.weights)))

    def _probe_grad_sens(self, model: GNN, stats):
        """Realized per-layer dw SR noise at the template widths, divided by
        the bit-scaling curve, so any candidate width re-prices as
        ``grad_sens * normalized_sr_variance(candidate)``."""
        s1, s2 = seeds.probe_seeds(self.seed)
        g1 = self._probe_dw(model, s1)
        g2 = self._probe_dw(model, s2)
        out = []
        for st, tmpl, p1, p2 in zip(stats, self.templates, g1, g2):
            if st is None or tmpl is None:
                out.append(st)
                continue
            noise = float(0.5 * torch.sum((p1 - p2) ** 2))
            sens = noise / max(autoprec.normalized_sr_variance(tmpl), 1e-30)
            # a zero probe (e.g. an untrained head with zero grads) keeps
            # the range-moment fallback rather than marking the layer free
            out.append(dataclasses.replace(st, grad_sens=sens or None))
        return out

    def _obs_sens(self, model: GNN, stats):
        """Telemetry-sourced sensitivities: the measured dequantization
        variance of each layer's stash at the template width, re-priced
        through :func:`repro_torch.core.autoprec.normalized_sr_variance`:
        the ``grad_sens`` contract without a gradient pass."""
        measured = measure_quant_health(model, self.graph, self.base_cfg,
                                        seed=self.seed)
        out = []
        for st, s in zip(stats, measured_sensitivity(measured,
                                                     self.templates)):
            if st is None or s is None:
                out.append(st)
                continue
            # a degenerate zero measurement (constant activations) keeps
            # the range-moment fallback, like a zero gradient probe
            out.append(dataclasses.replace(st, grad_sens=s or None))
        return out

    def allocate(self, model: GNN) -> tuple[GNNConfig, bool]:
        """(Re)solve the allocation from ``model``'s current weights;
        returns (cfg, changed)."""
        stats = collect_layer_stats(model, self.graph, self.base_cfg,
                                    seed=self.seed)
        if self.budget_bytes is None:
            self.budget_bytes = autoprec.budget_bytes_for(
                stats, self.templates, self.bit_budget)
        stats = (self._obs_sens(model, stats) if self.calibration == "obs"
                 else self._probe_grad_sens(model, stats))
        bits = autoprec.allocate_bits(stats, self.templates,
                                      self.budget_bytes)
        changed = bits != self.bits
        self.bits = bits
        return self.base_cfg.with_layer_bits(bits), changed

    def due(self, epoch: int) -> bool:
        return self.refresh > 0 and epoch > 0 and epoch % self.refresh == 0

    def extras(self) -> dict:
        return {"bits_per_layer": list(self.bits),
                "bit_budget_bytes": self.budget_bytes}
