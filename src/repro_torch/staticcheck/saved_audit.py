"""Saved-tensor audit: prove, per plan, that every byte autograd keeps for
the backward is planned (the port's counterpart of the reference's
``repro.staticcheck.jaxpr_audit``).

The port runs eagerly and has no jaxpr to read, so the audit runs the
forward of each plan-matrix case at the matrix's geometry and reads what
autograd keeps behind the output:

* every tensor :func:`torch.autograd.graph.saved_tensors_hooks` sees being
  saved (``ctx.save_for_backward`` of the custom Functions, and whatever a
  built-in op saves);
* every tensor reachable from the attributes of each custom Function node
  in the graph under the output: ``_StashGNN``'s ``ctx.stash`` residual
  (per-layer ``CompressedTensor`` fields and masks, or the device arenas),
  the per-op Functions' stashes.

Each one is classified:

* **pass-through**: it shares storage with an input or a parameter (the
  graph, the weights, the mesh tables): no new device memory;
* **planned**: its dtype and shape match one entry of the
  :class:`~repro_torch.offload.arena.StashPlan`-derived multiset
  (:func:`expected_residuals`, per
  :func:`~repro_torch.offload.engine.resolve_mechanism`): per-tensor
  fields, or the pooled arena pair.  The port holds uint32 words as int32
  bit views, so an int32 tensor is a ``uint32`` entry;
* **leak** (rule ``residual-leak``): an unmatched float tensor, an
  activation escaping the quantizer.  Unmatched integer tensors of more
  than one element are ``unplanned-residual``.

A planned entry that never appears is ``missing-stash``.  Host placements
(``host`` -> ``pageable``, ``pinned-paged`` -> ``pinned``) move the bytes
to the offload store, as the reference's callback store does: the device
residual holds no planned bytes, and the ledger is what
:func:`~repro_torch.offload.engine.host_store_bytes` gained over the
forward.  The per-case byte ledger is then cross-checked against
``graph.train.activation_memory_report`` (``ledger-mismatch`` beyond
:data:`LEDGER_RTOL`).  One backward per case then reads every planned
segment once; after it the host store must be back where it was
(``host-store-drain``).

The device arenas are allocated with each segment's start rounded up to
16 bytes (``StashPlan.padding_bytes``); the audit matches them at their
allocated size and counts the planned bytes.

Mesh plans: the reference audits its unified forward at per-partition
geometry.  The port's mesh runs its own per-op stack
(:func:`repro_torch.engine.forward.mesh_gnn_forward`), so the audit runs
that stack on one rank (no process group) over the partition's padded
rows, through the same classification.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.engine.plan import StashPolicy
from repro_torch.offload.arena import StashPlan
from repro_torch.offload.engine import (ArenaStore, HostArenas, HostStash,
                                        host_store_bytes, resolve_mechanism)
from repro_torch.staticcheck.findings import Finding
from repro_torch.staticcheck.matrix import AuditCase, audit_matrix

PASS = "saved-audit"

#: Relative tolerance of the ledger <-> memory-report cross-check.  The two
#: models agree byte-for-byte by construction; 1% is headroom, not slack.
LEDGER_RTOL = 0.01

_EDGES = 512  # the stash geometry does not depend on the edge count

#: The offload store's own objects: their bytes are the host store's,
#: counted through host_store_bytes, not device residuals.
_HOST_STORE = (ArenaStore, HostArenas, HostStash)


@dataclasses.dataclass
class AuditResult:
    key: str
    findings: list[Finding]
    ledger_bytes: int
    report_bytes: int
    n_saved: int = 0

    def to_json(self) -> dict:
        return {"key": self.key, "ledger_bytes": self.ledger_bytes,
                "report_bytes": self.report_bytes, "n_saved": self.n_saved,
                "findings": [f.to_json() for f in self.findings]}

    @classmethod
    def from_json(cls, d: dict) -> "AuditResult":
        return cls(key=d["key"],
                   findings=[Finding.from_json(f) for f in d["findings"]],
                   ledger_bytes=d["ledger_bytes"],
                   report_bytes=d["report_bytes"], n_saved=d["n_saved"])


@dataclasses.dataclass
class Forward:
    """What one audited forward left: its output, the findings on its
    saved tensors, the byte ledger, and how many tensors it saves beyond
    the pass-throughs (``device_bytes`` of them on a CUDA device)."""

    out: torch.Tensor
    findings: list[Finding]
    ledger_bytes: int
    n_saved: int
    device_bytes: int


def stash_mechanism(stash: StashPolicy) -> str:
    """``"tensor"`` for per-tensor stashes, else the arena placement's
    memory (:func:`~repro_torch.offload.engine.resolve_mechanism`)."""
    if stash.kind == "tensor":
        return "tensor"
    return resolve_mechanism(stash.placement)


def expected_residuals(splan: StashPlan,
                       mechanism: str) -> list[tuple[str, tuple, str]]:
    """(dtype, shape, label) multiset the plan says the residual holds."""
    if mechanism == "device":
        return [("uint32", (splan.u32_words,), "u32-arena"),
                ("float32", (splan.f32_elems,), "f32-arena")]
    if mechanism in ("pageable", "pinned"):
        # the bytes live in the host store; the residual keeps the RP
        # seeds as python ints
        return []
    exp = []
    for lp in splan.layers:
        tag = f"layer{lp.index}"
        if lp.cfg is not None:
            exp += [("uint32", (lp.n_blocks, lp.words_per_block),
                     f"{tag}/packed"),
                    ("float32", (lp.n_blocks,), f"{tag}/zero"),
                    ("float32", (lp.n_blocks,), f"{tag}/rng"),
                    ("uint32", (), f"{tag}/rp_seed")]
        else:
            exp.append(("float32", tuple(lp.shape), f"{tag}/raw"))
        if lp.mask is not None:
            exp.append(("uint32", (1, lp.mask.size), f"{tag}/mask"))
    return exp


def _allocated(splan: StashPlan, shape: tuple, label: str) -> tuple:
    """The shape an entry is allocated at: the device arenas whole, with
    their alignment words; every other entry as planned."""
    if label == "u32-arena":
        return (splan.u32_alloc_words,)
    if label == "f32-arena":
        return (splan.f32_alloc_elems,)
    return shape


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.int32:
        return "uint32"       # the port's uint32 words are int32 bit views
    return str(t.dtype).replace("torch.", "")


def tensors_in(obj) -> list[torch.Tensor]:
    """Every tensor reachable from ``obj`` through containers, dataclasses
    and the port's own objects (the offload store's are skipped).  The
    walk keeps each object it has seen, so no id is reused during it, and
    is a loop, not a recursive closure: a closure that calls itself is a
    reference cycle, which would keep the tensors it saw alive until the
    cyclic collector runs."""
    out, seen, todo = [], {}, [obj]
    while todo:
        o = todo.pop()
        if id(o) in seen:
            continue
        seen[id(o)] = o
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, _HOST_STORE):
            continue
        elif isinstance(o, dict):
            todo.extend(o.values())
        elif isinstance(o, (list, tuple)):
            todo.extend(o)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            todo.extend(getattr(o, f.name) for f in dataclasses.fields(o))
        elif (type(o).__module__.startswith("repro_torch")
              and hasattr(o, "__dict__")):
            todo.append(vars(o))
    return out


def _graph_nodes(out: torch.Tensor) -> list:
    """Every autograd node under ``out``.  The Python object of a C++ node
    lives only while it is referenced, and a new one may take a freed
    one's id: the walk keeps every node it has seen."""
    todo = [out.grad_fn] if out.grad_fn is not None else []
    seen = {}
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        todo.extend(nxt for nxt, _ in node.next_functions)
    return list(seen.values())


def _storage(t: torch.Tensor) -> tuple:
    return (t.device.type, t.device.index, t.untyped_storage().data_ptr())


def saved_by(forward) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Run ``forward()``; return its output and every tensor autograd keeps
    for the backward (hooked saves and the custom Functions' attributes),
    each storage view once."""
    hooked = []

    def pack(t):
        hooked.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = forward()
    found = list(hooked)
    for node in _graph_nodes(out):
        if isinstance(node, torch.autograd.function.BackwardCFunction):
            found += tensors_in(dict(vars(node)))
    uniq = {}
    for t in found:
        key = (_storage(t), t.storage_offset(), tuple(t.shape),
               tuple(t.stride()), t.dtype)
        uniq.setdefault(key, t)
    return out, list(uniq.values())


def audit_forward(forward, inputs, splan: StashPlan, mechanism: str,
                  where: str) -> Forward:
    """Audit one forward: ``forward()`` returns the output, ``inputs`` is
    everything a saved tensor may pass through from (graph, parameters,
    tables), ``splan`` the layout the stash must follow."""
    host0 = host_store_bytes()
    out, saved = saved_by(forward)
    passthrough = {_storage(t) for t in tensors_in(inputs) if t.numel()}
    remaining = [(dt, _allocated(splan, shape, label), shape, label)
                 for dt, shape, label in expected_residuals(splan,
                                                            mechanism)]
    findings: list[Finding] = []
    ledger = n_saved = device_bytes = 0
    for t in saved:
        if t.numel() == 0 or _storage(t) in passthrough:
            continue  # pass-through: no new memory
        n_saved += 1
        nb = t.numel() * t.element_size()
        if t.is_cuda:
            device_bytes += nb
        sig = (_dtype_name(t), tuple(t.shape))
        hit = next((e for e in remaining if (e[0], e[1]) == sig), None)
        if hit is not None:
            remaining.remove(hit)
            ledger += 4 * math.prod(hit[2])   # planned: 4-byte elements
            continue
        desc = f"{sig[0]}{list(sig[1])} residual ({nb} bytes)"
        if t.is_floating_point():
            ledger += nb
            findings.append(Finding(
                PASS, "residual-leak", where,
                f"{desc} is kept for the backward but is not accounted for "
                "in the StashPlan: an activation escaped the quantizer"))
        elif t.numel() > 1:
            ledger += nb
            findings.append(Finding(
                PASS, "unplanned-residual", where,
                f"{desc} is not in the StashPlan"))
        # unmatched integer scalars (stray seeds) are byte-negligible
    for dtype, _, shape, label in remaining:
        findings.append(Finding(
            PASS, "missing-stash", f"{where}/{label}",
            f"planned {dtype}{list(shape)} stash never appears among the "
            "saved tensors: the backward would read unwritten state"))
    if mechanism in ("pageable", "pinned"):
        ledger += host_store_bytes() - host0
    return Forward(out, findings, ledger, n_saved, device_bytes)


def drain(fwd: Forward, params, where: str, host_before: int) -> list:
    """One backward through ``fwd.out`` into ``params``: it reads every
    planned segment once, after which the host store holds what it held
    before the forward."""
    torch.autograd.grad(fwd.out, list(params), torch.ones_like(fwd.out))
    left = host_store_bytes() - host_before
    if left:
        return [Finding(PASS, "host-store-drain", where,
                        f"{left} stash bytes are still in the host store "
                        "after the backward: a planned segment was never "
                        "read back")]
    return []


# ----------------------------------------------------------------- setups
def gnn_setup(model, graph, cfg, stash: StashPolicy, fused: str,
              seed: int = 0):
    """The engine's whole-network forward of ``model`` on ``graph`` (a
    :class:`~repro_torch.graph.models.DeviceGraph`) under ``stash``:
    ``(forward, inputs, splan, mechanism)`` for :func:`audit_forward`."""
    from repro_torch.engine.forward import stash_gnn_forward
    from repro_torch.offload.gnn import plan_gnn_stashes

    n_nodes, in_dim = graph.features.shape
    splan = plan_gnn_stashes(cfg, in_dim, n_nodes)
    mechanism = stash_mechanism(stash)
    store = (None if stash.kind == "tensor" else
             ArenaStore(splan, stash.placement, graph.features.device))
    return (lambda: stash_gnn_forward(model, graph, cfg, seed, fused, store),
            (graph, model.flat_params()), splan, mechanism)


def mesh_setup(model, feats, tables, cfg, seed: int = 0):
    """The mesh's per-op forward on one rank (no process group) over one
    partition's padded rows: ``(forward, inputs, splan, mechanism)``."""
    from repro_torch.engine.forward import mesh_gnn_forward
    from repro_torch.offload.gnn import plan_gnn_stashes

    n_pad, in_dim = feats.shape
    return (lambda: mesh_gnn_forward(model, feats, tables, cfg,
                                     seed=seed)[0],
            (feats, tables, model.flat_params()),
            plan_gnn_stashes(cfg, in_dim, n_pad), "tensor")


def _case_setup(case: AuditCase, device: torch.device):
    from repro_torch.engine.seeds import sr_seed
    from repro_torch.graph.models import GNN, DeviceGraph, adjacency

    model = GNN(case.cfg, case.in_dim,
                generator=torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(0)
    seed = sr_seed(0)
    sp = case.plan.sampling
    if sp.kind == "mesh":
        from repro_torch.graph.data import synthetic_graph
        from repro_torch.parallel.halo import build_halo_program, rank_round

        g = synthetic_graph("audit", case.n_nodes, _EDGES, case.in_dim,
                            case.cfg.n_classes, seed=0)
        prog = build_halo_program(g, sp.n_parts, 1, method=sp.method,
                                  node_multiple=sp.node_multiple,
                                  edge_multiple=sp.edge_multiple)
        tables = rank_round(prog, 0, 0, case.cfg.arch, device)
        feats = torch.from_numpy(prog.features[0, 0]).to(device)
        return model, mesh_setup(model, feats, tables, case.cfg, seed)
    n = case.live_nodes
    mask = torch.ones(n, dtype=torch.float32)
    node_mask = None
    if sp.kind == "partition":
        mask[n - n // 8:] = 0          # a padded batch's pad rows
        node_mask = mask.to(device)
    graph = DeviceGraph(
        features=torch.from_numpy(rng.standard_normal(
            (n, case.in_dim)).astype(np.float32)).to(device),
        labels=torch.from_numpy(rng.integers(
            0, case.cfg.n_classes, n)).to(device),
        train_mask=mask.to(device), val_mask=mask.to(device),
        test_mask=mask.to(device),
        adj=adjacency(rng.integers(0, n, _EDGES), rng.integers(0, n, _EDGES),
                      rng.random(_EDGES).astype(np.float32), n, device),
        node_mask=node_mask)
    return model, gnn_setup(model, graph, case.cfg, case.plan.stash,
                            case.plan.kernel.fused, seed)


def report_bytes(case: AuditCase) -> int:
    """The case's bytes in ``activation_memory_report``: the full graph's,
    or one padded batch's / partition's peak."""
    from repro_torch.graph.train import activation_memory_report

    g = SimpleNamespace(n_feats=case.in_dim, n_nodes=case.n_nodes)
    rep = activation_memory_report(g, case.cfg, plan=case.plan)
    sp = case.plan.sampling
    if sp.kind == "full":
        return rep.get("compressed_bytes", rep["fp32_bytes"])
    return rep["mesh" if sp.kind == "mesh" else "batched"][
        "peak_saved_bytes"]


def audit_case(case: AuditCase, device="cuda") -> AuditResult:
    """Run ``case``'s forward and one backward on ``device`` (the card
    unless the CPU is asked for) and audit what autograd keeps."""
    device = resolve_device(device)
    host0 = host_store_bytes()
    model, (forward, inputs, splan, mechanism) = _case_setup(case, device)
    fwd = audit_forward(forward, inputs, splan, mechanism, case.key)
    findings = fwd.findings + drain(fwd, model.flat_params(), case.key,
                                    host0)
    report = report_bytes(case)
    if report and abs(fwd.ledger_bytes - report) > LEDGER_RTOL * report:
        findings.append(Finding(
            PASS, "ledger-mismatch", case.key,
            f"saved-tensor ledger ({fwd.ledger_bytes} bytes) diverges from "
            f"activation_memory_report ({report} bytes) by more than "
            f"{LEDGER_RTOL:.0%}"))
    return AuditResult(key=case.key, findings=findings,
                       ledger_bytes=fwd.ledger_bytes, report_bytes=report,
                       n_saved=fwd.n_saved)


def run(cases: list[AuditCase] | None = None,
        device="cuda") -> list[AuditResult]:
    return [audit_case(c, device) for c in (audit_matrix() if cases is None
                                            else cases)]
