"""Top-k MoE FFN with per-sequence-capacity dispatch (the reference's
``repro.models.moe``): plain functions on tensors.

Each sequence routes its S tokens to ``top_k`` of ``n_experts`` experts;
an expert takes at most ``capacity(S, ...)`` tokens of a sequence, in token
order, and the rest drop (they add nothing).  The router runs in float32
(softmax, top-k, the top-k gates renormalised) and returns the
Switch-style balance loss ``E/k * sum_e f_e * P_e`` beside the output.

Dispatch is the reference's gather formulation, so the same tokens drop: a
stable argsort of each sequence's flattened (S*k) expert ids groups the
(token, choice) pairs by expert in token order; the segment starts
(``searchsorted``) give each pair its position in its expert, ``keep =
pos < C``, and a dropped pair's slot is the dummy ``E*C``, a zero row.
Every expert slot gathers its token into a (E, B*C, D) buffer (underfull
slots are zero), the experts run as three batched products in the promoted
dtype of the activations and the expert weights (the reference's einsums;
:func:`repro_torch.models.layers.mm`'s rule), and the combine gathers each
choice's slot output and adds it, gate-weighted, in float32 over
j = 0..k-1.

Every expert's weights are read whatever the batch: at decode
(``capacity(1, 128, 8) = 8``) each slot still fills a (E, 8, D) buffer,
as in the reference.

``torch.topk`` orders tied probabilities as it likes, where the reference's
``lax.top_k`` keeps the lower index first; with continuous logits a tie is
a measure-zero event, and the tests use random logits.  The sort that
groups pairs by expert is stable, as the reference's is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def capacity(seq_len: int, n_experts: int, top_k: int,
             capacity_factor: float = 1.25, multiple: int = 8) -> int:
    """Tokens an expert takes from one sequence, rounded up to a multiple
    of ``multiple`` (at least ``multiple``)."""
    c = int(seq_len * top_k * capacity_factor / n_experts) + 1
    return max(multiple, ((c + multiple - 1) // multiple) * multiple)


def router_probs(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(B, S, D) activations -> (B, S, E) float32 routing probabilities."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    return torch.softmax(logits, dim=-1)


def route(probs: torch.Tensor, top_k: int, c: int,
          norm_topk: bool = True) -> dict:
    """The dispatch plan of (B, S, E) probabilities at capacity ``c``:
    ``gates`` and ``idx`` (B, S, k); ``keep = pos < c`` and ``slot``
    (``idx*c + pos``, or the dummy ``E*c`` where dropped), ``pos`` being
    each pair's position in its expert; and per expert slot (B, E*c) the
    token it reads ``src_tok`` and whether a pair fills it
    ``slot_valid``."""
    b, s, e = probs.shape
    k = top_k
    dev = probs.device
    gates, idx = torch.topk(probs, k, dim=-1)
    if norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    e_flat = idx.reshape(b, s * k)
    order = torch.argsort(e_flat, dim=1, stable=True)     # sorted by expert
    ar = torch.arange(s * k, device=dev)
    inv = torch.empty_like(order).scatter_(1, order, ar.expand(b, -1))
    sorted_e = torch.gather(e_flat, 1, order)
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(b, e).contiguous(),
        side="left")                                      # (B, E)
    pos_sorted = ar[None, :] - torch.gather(seg_start, 1, sorted_e)
    pos = torch.gather(pos_sorted, 1, inv).reshape(b, s, k)
    keep = pos < c
    slot = torch.where(keep, idx * c + pos, e * c)

    # expert slot (e, p) reads pair order[seg_start[e] + p], token // k
    flat_c = torch.arange(e * c, device=dev)
    slot_e, slot_pos = flat_c // c, flat_c % c
    sorted_idx = seg_start[:, slot_e] + slot_pos[None, :]  # (B, E*c)
    seg_end = torch.cat([seg_start[:, 1:],
                         torch.full((b, 1), s * k, device=dev,
                                    dtype=seg_start.dtype)], dim=1)
    slot_valid = sorted_idx < seg_end[:, slot_e]
    sorted_idx = torch.clamp(sorted_idx, max=s * k - 1)
    src_tok = torch.gather(order, 1, sorted_idx) // k
    return {"gates": gates, "idx": idx, "keep": keep, "slot": slot,
            "src_tok": src_tok, "slot_valid": slot_valid}


def _bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ w`` over the expert axis, in the promoted dtype."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.bmm(a.to(dt), w.to(dt))


def moe_ffn(x: torch.Tensor, p, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, norm_topk: bool = True):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux loss float32 scalar).

    ``p`` has ``router`` (D, E), ``w_gate`` / ``w_up`` (E, D, F) and
    ``w_down`` (E, F, D) as attributes (a layer's ``moe`` module).

    Expert stacks split over ``model`` (DTensors, the reference's
    ``experts`` rule, ``src/repro/models/moe.py:75-81``) run
    expert-parallel: routing is replicated on ``model`` (every rank routes
    its local rows with the whole router), each rank runs its E/m experts
    over their slots and adds their gate-weighted outputs into a partial
    y, and one all-reduce over ``model`` completes y; the gates and the
    expert inputs take their gradients summed over ``model``.  A DTensor
    ``x`` (the residual stream: its batch over the data axes) runs on its
    local rows and y comes back laid out as ``x``; the balance loss is
    then the whole batch's (its per-expert means averaged over the data
    axes) and comes back a replicated DTensor (a plain tensor would take a
    DTensor gradient from the loss it is added to).  A plain ``x`` beside
    DTensor weights is a decode step's local rows.  Unsplit, the expert
    range is all E and every collective is the identity."""
    from repro_torch.parallel import local as tp

    split = tp.split_over_model(p.w_gate)
    if {tp.split_over_model(p.w_up), tp.split_over_model(p.w_down)} \
            != {split}:
        raise ValueError("the expert stacks split over model apart")
    group = tp.model_group(p.w_gate)
    e, k = n_experts, top_k
    el = e // tp.axis_size(p.w_gate.device_mesh, tp.MODEL) if split else e
    e0 = tp.model_rank(p.w_gate) * el

    xl = tp.local_input(x, False)
    b, s, d = xl.shape
    c = capacity(s, e, k, capacity_factor)
    probs = router_probs(xl, tp.local_param(p.router, x, False))
    r = route(probs, k, c, norm_topk)

    # balance loss (Switch-style): E/k * sum_e f_e * P_e
    sel = F.one_hot(r["idx"], e).to(torch.float32).sum(2)        # (B,S,E)
    aux = e / k * torch.sum(tp.batch_mean(sel.mean((0, 1)), x)
                            * tp.batch_mean(probs.mean((0, 1)), x))

    # dispatch, expert-major: this rank's (E_l, B, C) tokens in one go
    src = r["src_tok"].reshape(b, e, c)[:, e0:e0 + el].transpose(0, 1)
    valid = r["slot_valid"].reshape(b, e, c)[:, e0:e0 + el].transpose(0, 1)
    rows = torch.arange(b, device=xl.device)[None, :, None]
    xe = tp.enter(xl, group)[rows, src] * valid[..., None].to(xl.dtype)
    xe = xe.reshape(el, b * c, d)

    # batched expert SwiGLU
    hidden = F.silu(_bmm(xe, tp.local_param(p.w_gate, x, split))) \
        * _bmm(xe, tp.local_param(p.w_up, x, split))
    ye = _bmm(hidden, tp.local_param(p.w_down, x, split))        # (E_l,B*C,D)

    # combine: each choice's slot output (a dropped pair's dummy slot and
    # another rank's experts' slots read the zero row E_l*C),
    # gate-weighted, summed over k in float32
    ye = ye.reshape(el, b, c, d).transpose(0, 1).reshape(b, el * c, d)
    ye_flat = F.pad(ye, (0, 0, 0, 1))
    gates = tp.enter(r["gates"], group)
    y = torch.zeros((b, s, d), dtype=torch.float32, device=xl.device)
    bidx = torch.arange(b, device=xl.device)[:, None]
    for j in range(k):
        slot = r["slot"][:, :, j] - e0 * c
        own = (slot >= 0) & (slot < el * c)
        yj = ye_flat[bidx, torch.where(own, slot, el * c)]
        w = gates[:, :, j] * (r["keep"][:, :, j] & own)
        y = y + yj.to(torch.float32) * w[..., None]
    y = tp.reduce(y, group)
    return tp.like(y.to(xl.dtype), x), tp.replicated(aux, x)
