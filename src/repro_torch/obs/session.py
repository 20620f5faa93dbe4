"""ObsSession: one run's observability state, built from the plan's
:class:`~repro_torch.obs.policy.ObsPolicy` (the reference's
``repro.obs.session``).

Bundles the tracer, the metrics registry and the quant-health monitor;
``activate()`` installs the tracer and registry as the process-wide actives
(so producers without a session at hand land in the same sinks) and
restores the previous ones on exit.  The shared :data:`NULL_SESSION` serves
every disabled run: its span and metric methods are no-ops, so the engine
instruments unconditionally.  Each rank of a mesh runs in its own process
with its own session; nothing is shared across ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pathlib

from repro_torch.obs import metrics as metricsmod
from repro_torch.obs import trace as tracemod
from repro_torch.obs.metrics import (NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM,
                                     MetricsRegistry)
from repro_torch.obs.policy import ObsPolicy
from repro_torch.obs.trace import Tracer


class ObsSession:
    def __init__(self, policy: ObsPolicy):
        self.policy = policy
        self.enabled = policy.enabled
        self.tracer: Tracer | None = (Tracer() if policy.enabled
                                      and policy.trace else None)
        self.registry: MetricsRegistry | None = (
            MetricsRegistry() if policy.enabled and policy.metrics else None)
        self._quant = None

    @classmethod
    def from_policy(cls, policy: ObsPolicy | None) -> "ObsSession":
        if policy is None or not policy.enabled:
            return NULL_SESSION
        return cls(policy)

    # ------------------------------------------------------------ lifetime
    @contextlib.contextmanager
    def activate(self):
        """Install this session's tracer and registry as the process actives
        for the duration (restoring the previous ones after)."""
        prev_t = tracemod.set_tracer(self.tracer) if self.tracer else None
        prev_m = (metricsmod.set_metrics(self.registry)
                  if self.registry else None)
        try:
            yield self
        finally:
            if self.tracer is not None:
                tracemod.set_tracer(prev_t)
            if self.registry is not None:
                metricsmod.set_metrics(prev_m)

    # --------------------------------------------------------------- spans
    def span(self, name: str, **args):
        return tracemod.open_span(self.tracer, name, args)

    # ------------------------------------------------------------- metrics
    def counter(self, name: str):
        return (self.registry.counter(name) if self.registry is not None
                else NULL_COUNTER)

    def gauge(self, name: str):
        return (self.registry.gauge(name) if self.registry is not None
                else NULL_GAUGE)

    def histogram(self, name: str, window: int = 64):
        return (self.registry.histogram(name, window=window)
                if self.registry is not None else NULL_HISTOGRAM)

    # -------------------------------------------------------- quant health
    def quant_due(self, epoch: int) -> bool:
        p = self.policy
        return (p.enabled and p.quant_stats
                and epoch % p.quant_stats_every == 0)

    def quant_probe(self, model, graph, epoch: int, cfg) -> None:
        """Run the telemetry probe on ``model`` over ``graph`` (a
        :class:`~repro_torch.graph.models.DeviceGraph`) and wait for its one
        copy to the host, so that neither the next epoch's time nor its
        loss read-back carries the probe's device work; the monitor is
        rebuilt when autoprec swaps the config."""
        from repro_torch.obs.quantstats import QuantHealthMonitor

        if self._quant is None or self._quant.cfg != cfg:
            self._quant = QuantHealthMonitor(cfg)
        self._quant.probe(model, graph, epoch)
        self._quant.wait()

    def quant_rows(self) -> list[dict]:
        return self._quant.rows() if self._quant is not None else []

    # -------------------------------------------------------------- export
    def export(self, base_path) -> dict:
        """Write the trace as ``<base>.jsonl`` and ``<base>.trace.json``
        (the latter loads directly in Perfetto); returns the paths."""
        if self.tracer is None:
            return {}
        p = pathlib.Path(base_path)
        if p.suffix in (".jsonl", ".json"):
            p = p.with_suffix("")
        p.parent.mkdir(parents=True, exist_ok=True)
        jsonl = p.with_suffix(".jsonl")
        chrome = p.with_suffix(".trace.json")
        self.tracer.export_jsonl(jsonl)
        self.tracer.export_chrome(chrome)
        return {"jsonl": str(jsonl), "chrome": str(chrome)}

    def summary(self) -> dict:
        out: dict = {"policy": dataclasses.asdict(self.policy)}
        if self.tracer is not None:
            out["n_spans"] = len(self.tracer.spans)
        if self.registry is not None:
            out["metrics"] = self.registry.snapshot()
        if self._quant is not None:
            out["quant_health"] = self.quant_rows()
        return out


#: The shared disabled session every obs-off run binds.
NULL_SESSION = ObsSession(ObsPolicy())
