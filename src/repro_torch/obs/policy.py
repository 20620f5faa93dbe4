"""ObsPolicy: the plan-composable observability contract (the reference's
``repro.obs.policy``).

The fifth :class:`~repro_torch.engine.plan.ExecutionPlan` policy.  The
default is fully disabled: a disabled policy costs nothing at run time (the
runner binds the shared null session, whose span and metric methods are
no-ops on singletons) and leaves the plan and the trajectory untouched.

``enabled=True`` turns on the host-side layer: spans around plan compile,
epochs, mesh rounds, autoprec re-solves and pager fetches (``trace``), and
the counters, gauges and histograms registry (``metrics``).  Neither reads
or writes anything the training step reads, so trajectories stay
**bit-identical** to a disabled run, and the epoch time with trace and
metrics on stays within 1.05 of the time with them off.

``quant_stats=True`` also runs the per-layer quantization-health probe
every ``quant_stats_every`` epochs: a separate pass
(:mod:`repro_torch.obs.quantstats`) that replays each compressed layer's
RP, block and SR steps through the compression kernels on the live
weights and brings block range moments, saturation rate and the measured
SR dequantization variance back to the host in one copy.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObsPolicy:
    enabled: bool = False
    trace: bool = True
    metrics: bool = True
    quant_stats: bool = False
    quant_stats_every: int = 10

    def __post_init__(self):
        # errors name the offending field as ``policy.field=value`` (the
        # ExecutionPlan convention)
        if self.quant_stats_every < 1:
            raise ValueError(f"obs.quant_stats_every={self.quant_stats_every} "
                             "must be >= 1")
        if self.quant_stats and not self.enabled:
            raise ValueError("obs.quant_stats=True is incompatible with "
                             "obs.enabled=False (the telemetry channel rides "
                             "the obs session; enable it)")
