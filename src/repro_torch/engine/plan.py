"""ExecutionPlan: the declarative contract between the GNN training entry
points and the engine (the reference's ``repro.engine.plan``).

A plan composes orthogonal policies:

* :class:`SamplingPolicy`: what is live at once, the full graph, padded
  partition-sampled subgraph batches (Cluster-GCN flavour) with their
  bucketing / halo / shuffle / grad-accum knobs, or partitions sharded over
  the ranks of a process group (mesh);
* :class:`PrecisionPolicy`: the widths the ``GNNConfig`` carries, or an
  autoprec byte budget with a refresh cadence;
* :class:`StashPolicy`: how saved-for-backward state is stored;
* :class:`KernelPolicy`: the compression stack's kernel backend and the
  fused matmul-quant pair's mode.

``train_gnn`` / ``train_gnn_batched`` build a plan with
:meth:`ExecutionPlan.from_legacy` and hand it to
:func:`repro_torch.engine.runner.run`.  Plans are frozen and hashable.

Not ported yet, and raising where it is asked for: the observability
policy (``obs``, ROADMAP A.10).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.backend import VALID_FUSED
from repro_torch.kernels.ops import VALID_IMPLS
from repro_torch.offload.engine import POLICIES

SAMPLING_KINDS = ("full", "partition", "mesh")
PRECISION_KINDS = ("fixed", "autoprec")
CALIBRATION_KINDS = ("probe", "obs")
STASH_KINDS = ("tensor", "arena")
#: The offload policies (:data:`repro_torch.offload.engine.POLICIES`).
STASH_PLACEMENTS = POLICIES


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
    """Full-graph, partition-sampled padded mini-batches
    (:func:`repro_torch.graph.sampling.make_subgraph_batches` takes
    ``method``, ``halo``, the bucket multiples and ``renormalize``;
    ``shuffle`` redraws the batch order each epoch; ``grad_accum`` batches
    make one optimizer update), or mesh-sharded partition-parallel training.

    ``kind="mesh"`` shards the ``n_parts`` partitions over the ``m`` ranks of
    a process group (``m`` must divide ``n_parts``) and trains them in
    ``n_parts // m`` rounds with a per-layer halo exchange between the
    round's co-resident partitions (:mod:`repro_torch.parallel.halo`); the
    features stay in host memory behind
    :class:`repro_torch.offload.pager.FeaturePager`.  ``m == 1`` is exactly
    the partition engine (static round order, one partition live at a
    time); ``m == n_parts`` is exact distributed full-graph training.  The
    ``halo``/``renormalize``/``grad_accum``/``shuffle`` knobs belong to the
    partition engine: mesh halo context is structural (the exchange), and
    rounds run one update each in static order."""

    kind: str = "full"            # "full" | "partition" | "mesh"
    n_parts: int = 1
    method: str = "bfs"           # "bfs" | "random"
    halo: int = 0
    node_multiple: int = 64
    edge_multiple: int = 256
    renormalize: bool = False
    shuffle: bool = True
    grad_accum: int = 1

    def __post_init__(self):
        # errors name the offending field as ``policy.field=value``
        if self.kind not in SAMPLING_KINDS:
            raise ValueError(f"sampling.kind={self.kind!r} not in "
                             f"{SAMPLING_KINDS}")
        if self.n_parts < 1:
            raise ValueError(f"sampling.n_parts={self.n_parts} must be >= 1")
        if self.grad_accum < 1:
            raise ValueError(f"sampling.grad_accum={self.grad_accum} "
                             "must be >= 1")
        if self.kind == "full" and self.n_parts != 1:
            raise ValueError(f"sampling.n_parts={self.n_parts} is "
                             "incompatible with sampling.kind='full' "
                             "(full-graph sampling has exactly one "
                             "partition)")
        if self.kind == "mesh":
            if self.grad_accum != 1:
                raise ValueError(f"sampling.grad_accum={self.grad_accum} is "
                                 "incompatible with sampling.kind='mesh' "
                                 "(mesh rounds run one update each; "
                                 "grad_accum needs kind='partition')")
            if self.halo != 0:
                raise ValueError(f"sampling.halo={self.halo} is incompatible "
                                 "with sampling.kind='mesh' (mesh halo "
                                 "context is structural: the per-layer "
                                 "exchange; the sampling halo knob applies "
                                 "to kind='partition' only)")
            if self.renormalize:
                raise ValueError("sampling.renormalize=True is incompatible "
                                 "with sampling.kind='mesh' (mesh slices "
                                 "full-graph aggregation weights; "
                                 "renormalize needs kind='partition')")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Fixed widths from the ``GNNConfig``, or an autoprec byte budget:
    ``bit_budget`` average stash bits an element, re-solved every
    ``refresh`` epochs (0 = once).  ``calibration="obs"`` needs the
    quant-health telemetry (A.10); the controller raises on it."""

    kind: str = "fixed"           # "fixed" | "autoprec"
    bit_budget: float | None = None
    refresh: int = 0
    calibration: str = "probe"    # "probe" | "obs"

    def __post_init__(self):
        if self.kind not in PRECISION_KINDS:
            raise ValueError(f"precision.kind={self.kind!r} not in "
                             f"{PRECISION_KINDS}")
        if self.calibration not in CALIBRATION_KINDS:
            raise ValueError(f"precision.calibration={self.calibration!r} "
                             f"not in {CALIBRATION_KINDS}")
        if self.kind == "autoprec" and self.bit_budget is None:
            raise ValueError("precision.bit_budget=None is incompatible "
                             "with precision.kind='autoprec' (autoprec "
                             "needs a bits-per-element budget)")
        if self.kind == "fixed" and self.bit_budget is not None:
            raise ValueError(f"precision.bit_budget={self.bit_budget} is "
                             "incompatible with precision.kind='fixed' "
                             "(use kind='autoprec')")
        if self.kind == "fixed" and self.calibration != "probe":
            raise ValueError(f"precision.calibration={self.calibration!r} "
                             "is incompatible with precision.kind='fixed' "
                             "(calibration is an autoprec knob)")


@dataclasses.dataclass(frozen=True)
class StashPolicy:
    """Where saved-for-backward stashes live: ``"tensor"``, per-tensor on
    the device, or ``"arena"``, one pooled arena pair
    (:mod:`repro_torch.offload`) at ``placement``: on the device, or moved
    to pageable (``"host"``) or page-locked (``"pinned-paged"``) host
    memory after each layer's forward and brought back one layer ahead of
    the backward."""

    kind: str = "tensor"          # "tensor" | "arena"
    placement: str = "device"     # "device" | "host" | "pinned-paged"

    def __post_init__(self):
        if self.kind not in STASH_KINDS:
            raise ValueError(f"stash.kind={self.kind!r} not in "
                             f"{STASH_KINDS}")
        if self.placement not in STASH_PLACEMENTS:
            raise ValueError(f"stash.placement={self.placement!r} (the "
                             f"offload= policy) not in {STASH_PLACEMENTS}")
        if self.kind == "tensor" and self.placement != "device":
            raise ValueError(f"stash.placement={self.placement!r} is "
                             "incompatible with stash.kind='tensor' "
                             "(per-tensor stashes are device-resident; "
                             "pooled placements need kind='arena')")

    @property
    def offload(self) -> str | None:
        """The legacy ``offload=`` kwarg this policy corresponds to."""
        return None if self.kind == "tensor" else self.placement


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Kernel backend override for the compression stack (None keeps each
    layer's ``CompressionConfig.impl``) and the fused pair's mode
    ("auto" | "on" | "off", :func:`repro_torch.core.backend.route_fused`)."""

    impl: str | None = None
    fused: str = "auto"

    def __post_init__(self):
        if self.impl is not None and self.impl not in VALID_IMPLS:
            raise ValueError(f"kernel.impl={self.impl!r} not in "
                             f"{VALID_IMPLS}")
        if self.fused not in VALID_FUSED:
            raise ValueError(f"kernel.fused={self.fused!r} not in "
                             f"{VALID_FUSED}")

    def apply(self, cfg):
        """Reroute a GNNConfig's compression stack onto this backend."""
        return cfg if self.impl is None else cfg.with_impl(self.impl)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """``obs`` stands for the reference's observability policy; anything
    but None raises (A.10)."""

    sampling: SamplingPolicy = SamplingPolicy()
    precision: PrecisionPolicy = PrecisionPolicy()
    stash: StashPolicy = StashPolicy()
    kernel: KernelPolicy = KernelPolicy()
    obs: None = None

    def __post_init__(self):
        if self.obs is not None:
            raise NotImplementedError(
                "ExecutionPlan(obs=...): observability is not ported yet "
                "(ROADMAP A.10)")

    @classmethod
    def from_legacy(cls, *, n_parts: int | None = None,
                    impl: str | None = None, fused: str = "auto",
                    offload: str | None = None,
                    bit_budget: float | None = None,
                    autoprec_refresh: int = 0, method: str = "bfs",
                    halo: int = 0, node_multiple: int = 64,
                    edge_multiple: int = 256, renormalize: bool = False,
                    shuffle: bool = True, grad_accum: int = 1,
                    obs=None) -> "ExecutionPlan":
        """The plan a keyword spelling means: ``n_parts=None`` is the
        full-graph loop, any integer (1 included) the partition engine;
        ``offload=None`` keeps per-tensor stashes, a policy string asks for
        the arena at that placement."""
        if n_parts is None:
            sampling = SamplingPolicy()
        else:
            sampling = SamplingPolicy(
                kind="partition", n_parts=n_parts, method=method, halo=halo,
                node_multiple=node_multiple, edge_multiple=edge_multiple,
                renormalize=renormalize, shuffle=shuffle,
                grad_accum=grad_accum)
        if bit_budget is None:
            precision = PrecisionPolicy()
        else:
            precision = PrecisionPolicy(kind="autoprec",
                                        bit_budget=float(bit_budget),
                                        refresh=int(autoprec_refresh))
        stash = (StashPolicy() if offload is None
                 else StashPolicy(kind="arena", placement=offload))
        return cls(sampling=sampling, precision=precision, stash=stash,
                   kernel=KernelPolicy(impl=impl, fused=fused), obs=obs)

    @property
    def offload(self) -> str | None:
        """Legacy ``offload=`` view of the stash policy."""
        return self.stash.offload

    def describe(self) -> str:
        """One-line summary for logs."""
        s = self.sampling
        if s.kind == "full":
            samp = "full-graph"
        elif s.kind == "mesh":
            samp = f"mesh x{s.n_parts} ({s.method})"
        else:
            samp = f"partition x{s.n_parts} ({s.method}, halo={s.halo})"
        prec = ("fixed" if self.precision.kind == "fixed"
                else f"autoprec {self.precision.bit_budget} bits/elt "
                     f"(refresh {self.precision.refresh})")
        return (f"sampling={samp} | precision={prec} | "
                f"stash={self.stash.kind}@{self.stash.placement} | "
                f"kernel={self.kernel.impl or 'cfg'} "
                f"fused={self.kernel.fused}")
