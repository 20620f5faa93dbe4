"""repro_torch.staticcheck: compression-invariant analysis of the port
(the reference's ``repro.staticcheck``).

Four gating passes (``python -m repro_torch.staticcheck``) plus an opt-in
dead-code sweep:

* :mod:`~repro_torch.staticcheck.saved_audit`: run every plan in the
  representative matrix and prove no activation bytes are kept for the
  backward outside the :class:`~repro_torch.offload.arena.StashPlan`, with
  a byte ledger cross-checked against ``activation_memory_report``;
* :mod:`~repro_torch.staticcheck.plan_verify`: symbolic ExecutionPlan x
  graph x arch feasibility (policy fields, cross-policy combinations,
  layer widths, arena and KV page layouts) without running anything;
* :mod:`~repro_torch.staticcheck.kernel_contracts`: pre/post conditions
  of ``fused_matmul`` / ``quant_blockwise`` / ``rp_matmul`` over the CUDA
  launch configurations the main path computes;
* :mod:`~repro_torch.staticcheck.seed_lint`: AST lint for seed/RNG
  discipline (raw scheme constants, ad-hoc ``manual_seed`` arithmetic,
  host nondeterminism and device-to-host reads on the training path,
  SR-stream reuse, obs taps on the stash path);
* :mod:`~repro_torch.staticcheck.deadcode`: unused-symbol sweep
  (``--dead-code``).

It imports torch, never jax, and nothing of the reference package.
"""
from repro_torch.staticcheck.findings import Finding, load_baseline, new_findings

__all__ = ["Finding", "load_baseline", "new_findings"]
