"""The representative plan matrix every pass runs over (the reference's
``repro.staticcheck.matrix``, over the port's ``engine/plan`` policies).

One small, fixed GNN geometry (SAGE, 256 nodes, one hidden layer) crossed
with the engine's policy axes:

* sampling: ``full`` / ``partition`` ("batched") / ``mesh``;
* precision: ``fixed`` (one INT2 config broadcast to every layer) or
  ``autoprec`` (a representative *solved* mixed-bit tuple: the audit
  checks the widths an allocation would stash, not the allocator);
* stash: per-tensor, or a pooled arena at ``device`` / ``host`` /
  ``pinned-paged``;
* fused: ``on`` / ``off``;

plus one random-projection arm (``rp_ratio=8``, the paper's D/R).
Combinations :class:`~repro_torch.engine.compile.CompiledMesh` rejects
(mesh x arena, mesh x autoprec, mesh x fused='on') are skipped, so the
matrix enumerates exactly the plans a training run could execute.  The
keys and their order are the reference's.

Every config here is all-layers-compressed: the saved-tensor audit
cross-checks its byte ledger against ``activation_memory_report``'s
``compressed_bytes`` model, and an uncompressed hidden layer is the one
case where the two models legitimately diverge (the report charges the
f32 ReLU context, the stash a 1-bit mask).
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.compressor import CompressionConfig
from repro_torch.engine.plan import (ExecutionPlan, KernelPolicy,
                                     PrecisionPolicy, SamplingPolicy,
                                     StashPolicy)
from repro_torch.graph.models import GNNConfig

#: Canonical audit geometry.  Every layer's linear input width is a
#: multiple of the group size, so the ``fused='on'`` arms run the fused
#: pair for real.
N_NODES = 256
IN_DIM = 32
N_PARTS = 4
NODE_MULTIPLE = 64
HIDDEN = (64,)
N_CLASSES = 8

_FIXED = CompressionConfig(bits=2, group_size=64)
_MIXED = (CompressionConfig(bits=1, group_size=64),
          CompressionConfig(bits=4, group_size=64))
_RP = CompressionConfig(bits=2, group_size=64, rp_ratio=8)


def gnn_cfg(compression) -> GNNConfig:
    return GNNConfig(arch="sage", hidden=HIDDEN, n_classes=N_CLASSES,
                     compression=compression)


@dataclasses.dataclass(frozen=True)
class AuditCase:
    """One plan-matrix cell: the plan plus the concrete layer widths the
    forward would stash under it."""

    key: str
    plan: ExecutionPlan
    cfg: GNNConfig
    n_nodes: int = N_NODES
    in_dim: int = IN_DIM

    @property
    def live_nodes(self) -> int:
        """Rows live at once: the full graph, or one padded batch (the
        same ceil-then-bucket model ``activation_memory_report`` uses)."""
        from repro_torch.graph.sampling import _bucket

        sp = self.plan.sampling
        if sp.kind == "full":
            return self.n_nodes
        return _bucket(-(-self.n_nodes // sp.n_parts), sp.node_multiple)


def audit_matrix() -> list[AuditCase]:
    """Every valid cell of the plan matrix, stable key order."""
    samplings = [
        ("full", SamplingPolicy()),
        ("batched", SamplingPolicy(kind="partition", n_parts=N_PARTS,
                                   node_multiple=NODE_MULTIPLE)),
        ("mesh", SamplingPolicy(kind="mesh", n_parts=N_PARTS,
                                node_multiple=NODE_MULTIPLE)),
    ]
    precisions = [
        ("fixed", PrecisionPolicy(), _FIXED),
        ("autoprec", PrecisionPolicy(kind="autoprec", bit_budget=2.5),
         _MIXED),
    ]
    stashes = [
        ("tensor", StashPolicy()),
        ("device", StashPolicy(kind="arena", placement="device")),
        ("host", StashPolicy(kind="arena", placement="host")),
        ("paged", StashPolicy(kind="arena", placement="pinned-paged")),
    ]
    cases = []
    for (sk, samp), (pk, prec, comp), (tk, stash), fz in itertools.product(
            samplings, precisions, stashes, ("on", "off")):
        if sk == "mesh" and (tk != "tensor" or pk != "fixed" or fz == "on"):
            continue  # combinations CompiledMesh rejects
        plan = ExecutionPlan(sampling=samp, precision=prec, stash=stash,
                             kernel=KernelPolicy(fused=fz))
        cases.append(AuditCase(key=f"{sk}/{pk}/{tk}/fused-{fz}", plan=plan,
                               cfg=gnn_cfg(comp)))
    cases.append(AuditCase(
        key="full/fixed-rp8/tensor/fused-off",
        plan=ExecutionPlan(kernel=KernelPolicy(fused="off")),
        cfg=gnn_cfg(_RP)))
    return cases
