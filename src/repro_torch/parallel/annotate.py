"""Logical-axis activation sharding annotations (the reference's
``repro.parallel.annotate``).

The model code annotates its major intermediates with *logical* axes
(``shard(h, "batch", None, None)``), resolved against the active mesh by
rules the launcher installs (:func:`set_rules` of :func:`rules_for`).
With no rules installed (unit tests, one-rank runs), or for a tensor that
is not a DTensor, :func:`shard` is the identity.  Otherwise it
redistributes the DTensor to the placements its logical axes map to: the
reference's ``with_sharding_constraint``, made an explicit collective
(an all-reduce of a partial sum, an all-gather, or a local slice).
"""
from __future__ import annotations

from repro_torch.parallel.sharding import axis_size, dp_axes, dp_size

_RULES: dict = {}


def set_rules(**mapping):
    """e.g. ``set_rules(batch=("data",), heads="model", dff="model", ...)``;
    no arguments uninstalls the rules."""
    global _RULES
    _RULES = dict(mapping)


def rules_for(cfg, mesh, per_step_batch: int, *, is_train: bool = True):
    """Standard rule set for an ArchConfig on a mesh (a ``DeviceMesh`` or a
    ``{name: size}`` mapping).

    ``is_train``: gradient accumulation divides the per-step batch into
    micro-batches only on the training path; prefill / decode see the
    full batch."""
    msz = axis_size(mesh, "model")
    dp, dp_total = dp_axes(mesh), dp_size(mesh)
    micro = (per_step_batch // max(cfg.grad_accum, 1) if is_train
             else per_step_batch)
    d_inner = cfg.ssm_expand * cfg.d_model
    heads_ok = cfg.n_heads % msz == 0
    return dict(
        batch=dp if micro % dp_total == 0 else None,
        heads="model" if heads_ok else None,
        # context-parallel fallback: when heads don't divide the TP axis,
        # shard the query sequence over `model` (k/v gathered) instead of
        # replicating attention
        q_seq=None if heads_ok else "model",
        kv_heads="model" if cfg.n_kv_heads % msz == 0 else None,
        # flattened projection out-dims: shardable whenever divisible, even
        # when the head count itself is not (resharded at the reshape)
        attn_out="model" if (cfg.n_heads * cfg.d_head) % msz == 0 else None,
        kv_out="model" if (cfg.n_kv_heads * cfg.d_head) % msz == 0 else None,
        dff="model" if cfg.d_ff % msz == 0 and cfg.d_ff else None,
        experts="model" if cfg.n_experts % msz == 0 and cfg.n_experts else None,
        vocab="model" if cfg.vocab % msz == 0 else None,
        ssm_heads="model" if (d_inner // max(cfg.ssm_headdim, 1)) % msz == 0
        else None,
        cache_seq="model",
        embed=None,
    )


def spec_of(*axes) -> tuple:
    """The mesh spec the logical ``axes`` map to under the installed rules."""
    return tuple(_RULES.get(a) if a is not None else None for a in axes)


def shard(x, *axes):
    """``x`` laid out by the logical ``axes`` (one a dim); the identity
    without installed rules or for a tensor that is not a DTensor.  As
    ``with_sharding_constraint``'s transpose constrains the cotangent, the
    gradient that flows back into the result is laid out the same way
    first (a partial sum is reduced here, not handed to the op that made
    ``x``)."""
    if not _RULES:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.parallel.sharding import placements

    if len(axes) != x.ndim:
        raise ValueError(f"shard: {len(axes)} logical axes for a "
                         f"{x.ndim}-dim tensor")
    want = placements(spec_of(*axes), x.device_mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    if x.requires_grad and x.grad_fn is not None:
        x.register_hook(lambda g: g if tuple(g.placements) == want
                        else g.redistribute(g.device_mesh, want))
    return x
