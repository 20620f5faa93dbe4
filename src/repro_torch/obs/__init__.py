"""Run-time observability: tracing, metrics, quantization-health telemetry
(the reference's ``repro.obs``).

Three layers, all off by default and all read-only (obs-on training is
bit-identical to obs-off):

* :mod:`~repro_torch.obs.trace`: nested host-time spans (plan compile,
  epochs, mesh rounds, autoprec re-solves, pager fetches), exported as
  JSONL and Chrome ``trace_event`` JSON (Perfetto loads it), and the
  :func:`~repro_torch.obs.trace.stopwatch` timing idiom;
* :mod:`~repro_torch.obs.metrics`: counters, gauges and windowed
  histograms with shared null singletons when disabled (pager overlap,
  halo bytes, recompile and step-build counts, the serving counters);
* :mod:`~repro_torch.obs.quantstats`: the opt-in per-layer probe through
  the compression kernels: measured SR dequantization variance, range
  moments and saturation rate per layer, copied to the host once a probe
  and reported beside the Eq. 10 prediction; also the
  ``calibration="obs"`` source for autoprec.

:class:`~repro_torch.obs.policy.ObsPolicy` composes it onto
:class:`~repro_torch.engine.plan.ExecutionPlan` as the fifth policy;
:class:`~repro_torch.obs.session.ObsSession` is one run's bundle of the
three.  Nothing here imports JAX, so every name loads eagerly (policy
first: ``engine.plan`` imports it while the engine package loads).
"""
from __future__ import annotations

from repro_torch.obs.policy import ObsPolicy  # noqa: F401
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, get_metrics,
                                     set_metrics)
from repro_torch.obs.trace import (Span, Tracer, get_tracer,  # noqa: F401
                                   set_tracer, span, stopwatch)
from repro_torch.obs.session import NULL_SESSION, ObsSession  # noqa: F401
from repro_torch.obs.quantstats import (QuantHealthMonitor,  # noqa: F401
                                        health_rows, measure_quant_health,
                                        measured_sensitivity, tap)

__all__ = ["ObsPolicy", "Tracer", "Span", "span", "stopwatch", "set_tracer",
           "get_tracer", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "get_metrics", "set_metrics", "ObsSession", "NULL_SESSION",
           "QuantHealthMonitor", "measure_quant_health", "health_rows",
           "measured_sensitivity", "tap"]
