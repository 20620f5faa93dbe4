"""Plan, compile, execute: the GNN training engine.  An
:class:`ExecutionPlan` composes the sampling (full graph | padded
partition batches | mesh-sharded partitions), precision (fixed |
autoprec), stash and kernel policies; :func:`compile_plan` builds the step
and :func:`run` drives it.

:mod:`~repro_torch.engine.plan` and :mod:`~repro_torch.engine.seeds` load
eagerly; the compiler and runtime import the graph package and resolve
lazily (PEP 562), so neither import order deadlocks."""
from __future__ import annotations

import importlib

from repro_torch.engine import seeds  # noqa: F401
from repro_torch.engine.plan import (ExecutionPlan, KernelPolicy,  # noqa: F401
                                     PrecisionPolicy, SamplingPolicy,
                                     StashPolicy)

_LAZY = {
    "run": "repro_torch.engine.runner",
    "compile_plan": "repro_torch.engine.compile",
    "masked_nll": "repro_torch.engine.compile",
    "stash_gnn_forward": "repro_torch.engine.forward",
    "mesh_gnn_forward": "repro_torch.engine.forward",
    "AutoprecController": "repro_torch.engine.precision",
}

__all__ = ["ExecutionPlan", "SamplingPolicy", "PrecisionPolicy",
           "StashPolicy", "KernelPolicy", "seeds", *_LAZY]


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'repro_torch.engine' has no attribute {name!r}")
