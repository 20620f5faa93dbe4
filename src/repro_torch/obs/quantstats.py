"""Quantization-health telemetry: the opt-in per-layer stats channel
(``ObsPolicy(quant_stats=True)``; the reference's ``repro.obs.quantstats``).

For every compressed layer the probe replays, on the live weights, the
stash pipeline training runs: the linear input, RP at the layer's
``rp_ratio`` under the forward pass's own seeds, regrouped into the layer's
blocks, stochastically rounded onto its level table, and read back.  It
runs the kernels that build the stash, through the same
:mod:`repro_torch.core.backend` calls as
:func:`repro_torch.core.compressor.compress` and ``decompress``
(``rp_project``, ``quant_pack`` and ``dequant_unpack`` on the card, their
plain versions on the CPU), and reduces each layer on the device to:

* block range moments (``E[r]``, ``E[r²]``: the allocator's sensitivity
  scale),
* the saturation rate (the share of elements on the endpoint codes 0 and
  B, read from the packed codes),
* the **measured** SR dequantization variance ``Σ(x̂ − x)²``: the realized
  value of the quantity the paper's Eq. 10 predicts.

The padded tail of the last block is left out of the error and saturation
sums by flat index.  All layers' stats come back to the host in one copy a
probe (:func:`tap`).  The probe runs under ``torch.no_grad()``, draws from
no torch generator (RP and SR are counter hashes of their seeds) and
writes nothing training reads, so obs-on trajectories are bit-identical to
obs-off.

:func:`health_rows` reports measured against predicted side by side (the
run-time check of the paper's variance model), and
:func:`measured_sensitivity` turns the measured variance into the
``grad_sens``-style per-layer scale :class:`AutoprecController` uses under
``PrecisionPolicy(calibration="obs")`` in place of the two-seed gradient
probe.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend
from repro_torch.core import pack as packmod
from repro_torch.core.autoprec import (LayerStats, expected_layer_variance,
                                       normalized_sr_variance)
from repro_torch.core.compressor import RP_SEED_SALT
from repro_torch.engine.seeds import layer_seed
from repro_torch.offload.engine import host_empty

#: Order of the per-layer stat vector :func:`layer_health` returns.
STAT_FIELDS = ("n_valid", "n_blocks", "sq_err", "rng_mean", "rng_sq_mean",
               "sat_rate")


def tap(stats: torch.Tensor) -> tuple[torch.Tensor, object]:
    """Start the one copy of a probe's stacked stats to the host; returns
    ``(host, event)``.

    The reference's ``tap`` ships the stats from inside jitted code through
    a host callback.  The port's probe runs eagerly, so its ``tap`` is a
    non-blocking copy into page-locked host memory with a CUDA event
    recorded after it: the host tensor is valid once the event has
    completed (:func:`_drain` waits on it), and the probe itself never
    blocks the host.  On the CPU the copy is plain and the event None."""
    if stats.device.type != "cuda":
        return stats.clone(), None
    host = host_empty(tuple(stats.shape), stats.dtype, pinned=True)
    host.copy_(stats, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(stats.device))
    return host, event


def _drain(host: torch.Tensor, event) -> np.ndarray:
    if event is not None:
        event.synchronize()
    return host.numpy()


@torch.no_grad()
def layer_health(x: torch.Tensor, comp, seed: int, li: int) -> torch.Tensor:
    """Health stats of one layer's stash (:data:`STAT_FIELDS`), a float64
    (6,) tensor on ``x``'s device.

    Replays the compress path on ``x`` as the training forward stashes it:
    SR seed ``layer_seed(seed, li)``, RP seed that ``^ RP_SEED_SALT``, the
    layer's own group size and level table, the backend ``comp.impl``
    names.  Sums run in float32, as the reference's do; the stack is
    float64 so the element and block counts stay exact."""
    ls = layer_seed(seed, li)
    xs = x.to(torch.float32)
    if comp.rp_ratio > 1:
        xs = backend.rp(xs, ls ^ RP_SEED_SALT, xs.shape[-1] // comp.rp_ratio,
                        impl=comp.impl)
    blocks, n_valid = backend.to_blocks(xs, comp.group_size)
    levels = comp.levels()
    packed, zero, rng = backend.quantize_blocks(blocks, comp.bits, ls, levels,
                                                impl=comp.impl)
    deq = backend.dequantize_blocks(packed, zero, rng, comp.bits,
                                    comp.group_size, levels, impl=comp.impl)
    codes = packmod.unpack(packed, comp.bits, comp.group_size)
    top = 2**comp.bits - 1
    sat = ((codes == 0) | (codes == top)).reshape(-1)[:n_valid]
    sq_err = ((deq - blocks) ** 2).reshape(-1)[:n_valid].sum()
    rngf = rng.to(torch.float32)

    def const(v, dtype=torch.float64):
        # a fill on the device: no host-to-device copy, so no wait
        return torch.full((), float(v), dtype=dtype, device=x.device)

    stats = [const(n_valid), const(blocks.shape[0]), sq_err, rngf.mean(),
             (rngf ** 2).mean(),
             sat.sum(dtype=torch.float32) / const(n_valid, torch.float32)]
    return torch.stack([s.to(torch.float64) for s in stats])


def _compressed_layers(cfg) -> list[int]:
    return [li for li, c in enumerate(cfg.layer_compression())
            if c is not None]


@torch.no_grad()
def _stacked_health(model, graph, cfg, seed: int) -> torch.Tensor:
    """(L_compressed, 6) stacked stats over the network, on the device."""
    # lazy: the graph package imports the engine at module load
    from repro_torch.graph.analysis import _iter_layer_inputs

    per_layer = cfg.layer_compression()
    rows = [layer_health(x, per_layer[li], seed, li)
            for li, x in _iter_layer_inputs(model, graph, cfg)
            if per_layer[li] is not None]
    if not rows:
        return torch.zeros((0, len(STAT_FIELDS)), dtype=torch.float64,
                           device=graph.features.device)
    return torch.stack(rows)


def _unpack(cfg, arr: np.ndarray) -> list[dict | None]:
    """One measured dict per network layer (None where uncompressed)."""
    out: list[dict | None] = [None] * len(cfg.layer_compression())
    for li, row in zip(_compressed_layers(cfg), arr):
        n_valid, n_blocks, sq_err, rmean, rsq, sat = (float(v) for v in row)
        out[li] = {"layer": li, "n_elements": int(n_valid),
                   "n_blocks": int(n_blocks), "measured_var": sq_err,
                   "rng_mean": rmean, "rng_sq_mean": rsq, "sat_rate": sat}
    return out


def measure_quant_health(model, graph, cfg, seed: int = 0
                         ) -> list[dict | None]:
    """Run the probe once and wait for it; per-layer measured dicts.

    The same probe and :func:`tap` channel the run-time monitor uses,
    drained at once: what ``AutoprecController`` calls under
    ``calibration="obs"``.  ``graph`` is a
    :class:`~repro_torch.graph.models.DeviceGraph` on ``model``'s device."""
    return _unpack(cfg, _drain(*tap(_stacked_health(model, graph, cfg,
                                                    seed))))


def health_rows(measured, templates) -> list[dict]:
    """Measured rows merged with the Eq. 10 prediction, side by side.

    The prediction is priced from the probe's *own* observed range moments,
    ``n_blocks · G · E[r²] · normalized_sr_variance``, so the ratio column
    isolates the distribution-model error (CN_[1/D] against the empirical
    activations), not the range estimate."""
    rows = []
    for m, tmpl in zip(measured, templates):
        if m is None or tmpl is None:
            continue
        stat = LayerStats(shape=(m["n_elements"],), n_blocks=m["n_blocks"],
                          rng_sq_mean=m["rng_sq_mean"])
        pred = expected_layer_variance(stat, tmpl)
        rows.append({**m, "bits": tmpl.bits, "predicted_var": pred,
                     "ratio": (m["measured_var"] / pred if pred > 0
                               else float("inf"))})
    return rows


def measured_sensitivity(measured, templates) -> list[float | None]:
    """Per-layer sensitivity from the measured dequantization variance.

    Divides out the template width's bit-scaling curve, so any candidate
    width re-prices as ``sens * normalized_sr_variance(candidate)``: the
    contract :class:`repro_torch.core.autoprec.LayerStats.grad_sens`
    carries, sourced from telemetry instead of the two-seed gradient
    probe."""
    out: list[float | None] = []
    for m, tmpl in zip(measured, templates):
        if m is None or tmpl is None:
            out.append(None)
            continue
        out.append(m["measured_var"]
                   / max(normalized_sr_variance(tmpl), 1e-30))
    return out


class QuantHealthMonitor:
    """The run-time channel: one probe per call, its stats copied to the
    host without a wait (:func:`tap`; :meth:`wait` waits for the latest),
    merged rows on demand."""

    def __init__(self, cfg, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        self.templates = cfg.layer_compression()
        #: (epoch, host stats, event the copy completes at)
        self.records: list[tuple[int, torch.Tensor, object]] = []

    def probe(self, model, graph, epoch: int) -> None:
        host, event = tap(_stacked_health(model, graph, self.cfg, self.seed))
        self.records.append((int(epoch), host, event))

    def wait(self) -> None:
        """Wait for the latest probe's copy to land (its CUDA event; one
        wait a probe, and nothing on the CPU)."""
        if self.records and self.records[-1][2] is not None:
            self.records[-1][2].synchronize()

    def _rows(self, host, event) -> list[dict]:
        return health_rows(_unpack(self.cfg, _drain(host, event)),
                           self.templates)

    def rows(self) -> list[dict]:
        """The latest probe's measured-vs-Eq.10 rows (waits for its copy)."""
        if not self.records:
            return []
        epoch, host, event = self.records[-1]
        rows = self._rows(host, event)
        for r in rows:
            r["epoch"] = epoch
        return rows

    def history(self) -> list[tuple[int, list[dict]]]:
        return [(e, self._rows(h, ev)) for e, h, ev in self.records]
