"""Symbolic plan/arena verifier: ExecutionPlan x graph x arch checks that
need no forward (the reference's ``repro.staticcheck.plan_verify``, over
the port's objects).

Four layers of checks, all pure arithmetic over static plan state:

* **policy fields**: re-raise the engine dataclasses' own validation
  (:mod:`repro_torch.engine.plan` names the offending ``policy.field=value``
  in every message; :func:`verify_legacy_kwargs` surfaces them as findings);
* **cross-policy combinations**: the constraints
  :mod:`repro_torch.engine.compile` and :mod:`repro_torch.engine.runner`
  enforce when a plan is lowered (mesh x arena, mesh x autoprec, mesh x
  fused='on', host offload under data parallelism, whole update groups,
  the mesh's group size, obs-sourced autoprec calibration needing the
  telemetry channel enabled), checked here without building a batch;
* **per-layer feasibility**: every layer's quantization config against
  :func:`repro_torch.kernels.quant_blockwise.unsupported` (autoprec
  mixed-bit tuples included), RP divisibility, and ``fused='on'``
  eligibility through :func:`repro_torch.core.backend.fused_unsupported`
  (:func:`repro_torch.kernels.fused_matmul.unsupported` and the layout
  rule): the predicates the port routes on;
* **arena layout**: every :class:`~repro_torch.offload.arena.StashPlan`
  segment proven in-bounds and non-overlapping in both of its layouts (the
  reference's unpadded ``offset`` and the allocated, 16-byte aligned
  ``start``), its geometry re-derived and compared (ragged 1-bit mask
  tails must be word-aligned *ceil*: the historical ``// 8`` floor bug
  class); and every serving
  :class:`~repro_torch.serving.kvcache.KVPageLayout` page word-aligned,
  sized, in-bounds and non-overlapping.

The mesh rule follows the port: :func:`repro_torch.parallel.halo.graph_mesh`
raises unless the group's size divides ``n_parts``, where the reference
shrinks its mesh to the largest divisor that fits its devices.
"""
from __future__ import annotations

import math

from repro_torch.core import backend
from repro_torch.core import pack as packmod
from repro_torch.engine.plan import ExecutionPlan
from repro_torch.kernels import quant_blockwise
from repro_torch.offload.arena import ALIGN_WORDS, StashPlan, _stash_geometry
from repro_torch.staticcheck.findings import Finding

PASS = "plan-verify"


def verify_legacy_kwargs(where: str = "kwargs", **kwargs) -> list[Finding]:
    """Validate a legacy kwarg spelling by building its plan; the policy
    dataclasses' field-named messages become the findings verbatim."""
    try:
        ExecutionPlan.from_legacy(**kwargs)
    except (ValueError, TypeError) as e:
        return [Finding(PASS, "policy-field", where, str(e))]
    return []


def verify_combination(plan: ExecutionPlan, *, devices: int = 1,
                       where: str = "plan") -> list[Finding]:
    """The cross-policy rules lowering the plan would reject; ``devices``
    is the size of the process group it would train on."""
    out = []
    sp = plan.sampling

    def bad(rule, msg):
        out.append(Finding(PASS, rule, where, msg))

    if sp.kind == "mesh":
        if plan.stash.kind != "tensor":
            bad("mesh-stash",
                f"stash.kind={plan.stash.kind!r} is incompatible with "
                "sampling.kind='mesh' (mesh ranks stash per-tensor "
                "residuals; the features are what is host-resident)")
        if plan.precision.kind != "fixed":
            bad("mesh-precision",
                f"precision.kind={plan.precision.kind!r} is incompatible "
                "with sampling.kind='mesh' (calibrate autoprec on a "
                "partition plan and pass the allocated cfg)")
        if plan.kernel.fused == "on":
            bad("mesh-fused",
                "kernel.fused='on' is incompatible with "
                "sampling.kind='mesh' (the mesh forward composes the "
                "per-op stack; use 'auto'/'off')")
        if sp.n_parts % max(devices, 1):
            bad("mesh-divisor",
                f"sampling.n_parts={sp.n_parts} is not a multiple of the "
                f"{devices}-rank group: graph_mesh raises (a rank cannot "
                "sit idle the way the reference's spare device does)")
    pp = plan.precision
    if (pp.kind == "autoprec" and pp.calibration == "obs"
            and not (plan.obs.enabled and plan.obs.quant_stats)):
        bad("obs-calibration",
            "precision.calibration='obs' sources sensitivities from the "
            "quant-health probe; the plan needs "
            "obs=ObsPolicy(enabled=True, quant_stats=True)")
    if sp.kind == "partition":
        group = max(devices, 1) * sp.grad_accum
        if sp.n_parts % group:
            bad("update-group",
                f"sampling.n_parts={sp.n_parts} must be a multiple of "
                f"dp*grad_accum={devices}*{sp.grad_accum}={group} "
                "(whole update groups per epoch)")
        if plan.stash.offload in ("host", "pinned-paged") and devices > 1:
            bad("offload-dp",
                f"stash.placement={plan.stash.placement!r} needs an "
                f"unsharded run (dp_size==1); got dp={devices}")
    return out


def verify_layers(plan: ExecutionPlan, cfg, in_dim: int, live_nodes: int,
                  where: str = "plan") -> list[Finding]:
    """Bit-width / RP / fused-eligibility feasibility per layer."""
    from repro_torch.graph.models import _dims

    out = []
    try:
        per = cfg.layer_compression()
    except ValueError as e:
        return [Finding(PASS, "layer-widths", where, str(e))]
    dims = _dims(cfg, in_dim)
    for li, (d_in, comp) in enumerate(zip(dims[:-1], per)):
        if comp is None:
            continue
        lin_in = d_in * (2 if cfg.arch == "sage" else 1)
        lwhere = f"{where}/layer{li}"
        reason = quant_blockwise.unsupported(comp.bits, comp.group_size,
                                             comp.levels())
        if reason is not None:
            out.append(Finding(PASS, "bit-alignment", lwhere, reason))
        if comp.rp_ratio > 1 and lin_in % comp.rp_ratio:
            out.append(Finding(
                PASS, "rp-divisibility", lwhere,
                f"stash width {lin_in} is not divisible by "
                f"rp_ratio={comp.rp_ratio} (compress would raise)"))
        if plan.kernel.fused == "on":
            reason = backend.fused_unsupported((live_nodes, lin_in),
                                               comp.bits, comp.group_size,
                                               comp.levels())
            if reason is None and comp.rp_ratio > 1:
                reason = (f"rp_ratio={comp.rp_ratio} projects before "
                          "quantization; the fused epilogue quantizes the "
                          "matmul operand itself")
            if reason is not None:
                out.append(Finding(
                    PASS, "fused-eligibility", lwhere,
                    f"kernel.fused='on' cannot run this layer: {reason}"))
    return out


def _overlaps(spans: list[tuple[int, int, str]], layout: str,
              arena: str) -> list[Finding]:
    out = []
    spans = sorted(spans)
    for (a0, a1, wa), (b0, b1, wb) in zip(spans[:-1], spans[1:]):
        if b0 < a1:
            out.append(Finding(
                PASS, "arena-overlap", wb,
                f"[{b0}, {b1}) overlaps {wa} [{a0}, {a1}) in the {arena} "
                f"arena ({layout} layout)"))
    return out


def verify_stash_plan(splan: StashPlan,
                      where: str = "stash-plan") -> list[Finding]:
    """Prove every arena segment in-bounds, non-overlapping and sized to
    its re-derived geometry, in the planned (``offset``) and the allocated
    (``start``) layout, each start on a 16-byte boundary."""
    out = []
    planned = {"u32": [], "f32": []}
    placed = {"u32": [], "f32": []}
    limits = {"u32": splan.u32_words, "f32": splan.f32_elems}
    alloc = {"u32": splan.u32_alloc_words, "f32": splan.f32_alloc_elems}
    for lp in splan.layers:
        lwhere = f"{where}/layer{lp.index}"
        for name, seg in (("packed", lp.packed), ("rp_seed", lp.rp_seed),
                          ("zero", lp.zero), ("rng", lp.rng),
                          ("raw", lp.raw), ("mask", lp.mask)):
            if seg is None:
                continue
            swhere = f"{lwhere}/{name}"
            if seg.arena not in planned:
                out.append(Finding(PASS, "arena-bounds", swhere,
                                   f"unknown arena {seg.arena!r}"))
                continue
            if seg.offset < 0 or seg.offset + seg.size > limits[seg.arena]:
                out.append(Finding(
                    PASS, "arena-bounds", swhere,
                    f"[{seg.offset}, {seg.offset + seg.size}) lies outside "
                    f"the {limits[seg.arena]}-word {seg.arena} arena"))
            if seg.start < 0 or seg.start + seg.size > alloc[seg.arena]:
                out.append(Finding(
                    PASS, "arena-bounds", swhere,
                    f"allocated [{seg.start}, {seg.start + seg.size}) lies "
                    f"outside the {alloc[seg.arena]}-word allocated "
                    f"{seg.arena} arena"))
            if seg.start % ALIGN_WORDS:
                out.append(Finding(
                    PASS, "arena-alignment", swhere,
                    f"start {seg.start} is not a multiple of {ALIGN_WORDS} "
                    "words: the view handed to a kernel must start on a "
                    "16-byte boundary"))
            planned[seg.arena].append(
                (seg.offset, seg.offset + seg.size, swhere))
            placed[seg.arena].append(
                (seg.start, seg.start + seg.size, swhere))
        if lp.cfg is not None:
            try:
                proj_shape, n_blocks, wpb = _stash_geometry(lp.shape, lp.cfg)
            except ValueError as e:
                out.append(Finding(PASS, "rp-divisibility", lwhere, str(e)))
                continue
            if (lp.proj_shape, lp.n_blocks, lp.words_per_block) != \
                    (proj_shape, n_blocks, wpb):
                out.append(Finding(
                    PASS, "arena-geometry", lwhere,
                    f"planned geometry (proj={lp.proj_shape}, "
                    f"blocks={lp.n_blocks}x{lp.words_per_block}w) does not "
                    f"match the config's (proj={proj_shape}, "
                    f"blocks={n_blocks}x{wpb}w)"))
            for name, seg, want in (("packed", lp.packed, n_blocks * wpb),
                                    ("rp_seed", lp.rp_seed, 1),
                                    ("zero", lp.zero, n_blocks),
                                    ("rng", lp.rng, n_blocks)):
                if seg is None or seg.size != want:
                    got = "absent" if seg is None else f"{seg.size} words"
                    out.append(Finding(
                        PASS, "arena-geometry", f"{lwhere}/{name}",
                        f"segment must span {want} words, got {got}"))
        else:
            numel = math.prod(lp.shape)
            if lp.raw is None or lp.raw.size != numel:
                got = "absent" if lp.raw is None else f"{lp.raw.size} elems"
                out.append(Finding(
                    PASS, "arena-geometry", f"{lwhere}/raw",
                    f"raw f32 stash of shape {lp.shape} must span {numel} "
                    f"elements, got {got}"))
        if lp.mask_elems:
            want = packmod.packed_len(lp.mask_elems, 1)
            if lp.mask is None or lp.mask.size != want:
                got = "absent" if lp.mask is None else f"{lp.mask.size}"
                out.append(Finding(
                    PASS, "mask-alignment", f"{lwhere}/mask",
                    f"1-bit ReLU mask over {lp.mask_elems} elements needs "
                    f"{want} word-aligned uint32 words (ceil), got {got}: "
                    "a floor-divided ragged tail drops the partial word"))
        elif lp.mask is not None:
            out.append(Finding(PASS, "arena-geometry", f"{lwhere}/mask",
                               "mask segment present but mask_elems == 0"))
    for arena in planned:
        out += _overlaps(planned[arena], "planned", arena)
        out += _overlaps(placed[arena], "allocated", arena)
    return out


def verify_kv_layout(layout, where: str = "kv-layout",
                     segments=None) -> list[Finding]:
    """Prove a serving :class:`~repro_torch.serving.kvcache.KVPageLayout`'s
    page map sound: every (layer, page) segment word-aligned to the quant
    packing, sized to the re-derived geometry, in-bounds of the pool's
    flat word space, and non-overlapping.  ``segments`` defaults to the
    layout's own map; tests inject crafted maps to pin each rule."""
    out = []
    if layout.quantized:
        vals_per_word = 32 // layout.bits
        if layout.group_size % vals_per_word:
            out.append(Finding(
                PASS, "kv-page-alignment", where,
                f"group_size={layout.group_size} does not pack whole uint32 "
                f"words at bits={layout.bits} ({vals_per_word} values/word); "
                "a token's trailing block would straddle a word"))
        want_wpb = packmod.packed_len(layout.group_size, layout.bits)
        want_wpp = layout.page_tokens * layout.blocks_per_token * want_wpb
    else:
        want_wpp = layout.page_tokens * layout.elems_per_token * 2 // 4
    if layout.words_per_page != want_wpp:
        out.append(Finding(
            PASS, "kv-page-geometry", where,
            f"words_per_page={layout.words_per_page} does not match the "
            f"re-derived {want_wpp} (page_tokens={layout.page_tokens} x "
            f"{layout.blocks_per_token} blocks/token at bits={layout.bits})"))
    if layout.elems_per_token % max(layout.group_size, 1):
        out.append(Finding(
            PASS, "kv-page-geometry", where,
            f"group_size={layout.group_size} does not divide the "
            f"{layout.elems_per_token}-element token row; a quant block "
            "would straddle tokens"))
    total = layout.total_words
    spans = []
    segs = list(layout.page_segments()) if segments is None else segments
    for li, p, off, size in segs:
        swhere = f"{where}/layer{li}/page{p}"
        if size != layout.words_per_page:
            out.append(Finding(
                PASS, "kv-page-geometry", swhere,
                f"segment spans {size} words, layout says "
                f"{layout.words_per_page} per page"))
        if off < 0 or off + size > total:
            out.append(Finding(
                PASS, "kv-page-bounds", swhere,
                f"[{off}, {off + size}) lies outside the {total}-word pool"))
        spans.append((off, off + size, swhere))
    spans.sort()
    for (a0, a1, wa), (b0, b1, wb) in zip(spans[:-1], spans[1:]):
        if b0 < a1:
            out.append(Finding(
                PASS, "kv-page-overlap", wb,
                f"[{b0}, {b1}) overlaps {wa} [{a0}, {a1})"))
    return out


def verify_kv_matrix() -> list[Finding]:
    """KV-page soundness across every supported serving cache width, over
    the canonical smoke decode geometry."""
    from repro_torch.serving.kvcache import (KV_BITS, KVCacheConfig,
                                             plan_kv_layout)

    out = []
    for bits in KV_BITS:
        layout = plan_kv_layout(
            KVCacheConfig(bits=bits, group_size=64, page_tokens=16,
                          n_pages=64),
            n_layers=2, n_kv_heads=4, d_head=16)
        out.extend(verify_kv_layout(layout, where=f"kv-layout/bits{bits}"))
    return out


def verify_plan(plan: ExecutionPlan, cfg, in_dim: int, n_nodes: int, *,
                devices: int = 1, where: str | None = None) -> list[Finding]:
    """All symbolic checks for one (plan, model, graph-size) triple."""
    from repro_torch.graph.sampling import _bucket
    from repro_torch.offload.gnn import plan_gnn_stashes

    where = where or plan.describe()
    out = verify_combination(plan, devices=devices, where=where)
    sp = plan.sampling
    if sp.kind == "full":
        live = n_nodes
    else:
        if sp.n_parts > n_nodes:
            out.append(Finding(
                PASS, "partition-count", where,
                f"sampling.n_parts={sp.n_parts} exceeds the graph's "
                f"{n_nodes} nodes"))
            return out
        live = _bucket(-(-n_nodes // sp.n_parts), sp.node_multiple)
    out += verify_layers(plan, cfg, in_dim, live, where)
    if not any(x.rule in ("rp-divisibility", "layer-widths") for x in out):
        out += verify_stash_plan(plan_gnn_stashes(cfg, in_dim, live),
                                 where=where)
    return out
