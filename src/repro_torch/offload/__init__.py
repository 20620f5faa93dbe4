"""Stash arena: pooled compressed-activation storage with host offload and
backward prefetch (the reference's ``repro.offload``).

* :mod:`repro_torch.offload.arena`: the static planner that lays every
  layer's ``packed``/``zero``/``rng``/``rp_seed`` fields (plus 1-bit ReLU
  masks and the raw f32 stash of an uncompressed layer) into one u32 and
  one f32 arena (:class:`StashPlan`), and the bit-exact
  ``stash_write``/``stash_read``.
* :mod:`repro_torch.offload.engine`: the placements ``{"device", "host",
  "pinned-paged"}``: the arena on the card, or each layer's segments moved
  to pageable or page-locked host memory after its forward on a side CUDA
  stream and brought back one layer ahead of the backward walk.
* :mod:`repro_torch.offload.gnn`: the GNN stash planner
  (:func:`plan_gnn_stashes`); the forward that consumes it is
  :mod:`repro_torch.engine.forward`.
* :mod:`repro_torch.offload.pager`: :class:`FeaturePager`, the mesh
  engine's host-resident features, one round's pages copied ahead on a side
  stream.

Entry points: an arena :class:`~repro_torch.engine.plan.StashPolicy` on an
``ExecutionPlan`` (``train_gnn(offload=...)``,
``train_gnn_batched(offload=...)``), and the serving KV cache's
``host`` / ``pinned-paged`` policies (:mod:`repro_torch.serving.kvcache`).
"""
from repro_torch.offload.arena import (StashPlan, arena_init, plan_stashes,
                                       read_mask, read_raw, stash_read,
                                       stash_write, write_mask, write_raw)
from repro_torch.offload.engine import (POLICIES, ArenaStore, check_policy,
                                        device_memory_stats,
                                        device_resident_stash_bytes,
                                        host_store_bytes, make_reader,
                                        make_writer, measure_live_bytes,
                                        resolve_mechanism)
from repro_torch.offload.gnn import plan_gnn_stashes
from repro_torch.offload.pager import OVERLAP_WINDOW, FeaturePager

__all__ = [
    "StashPlan", "plan_stashes", "arena_init",
    "stash_write", "stash_read", "write_raw", "read_raw",
    "write_mask", "read_mask",
    "POLICIES", "check_policy", "resolve_mechanism", "ArenaStore",
    "make_writer", "make_reader", "measure_live_bytes", "host_store_bytes",
    "device_resident_stash_bytes", "device_memory_stats",
    "plan_gnn_stashes", "FeaturePager", "OVERLAP_WINDOW",
]
