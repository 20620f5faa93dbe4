"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block (the
reference's ``repro.models.ssm``): plain functions on tensors.

Training and prefill run the chunked SSD: an intra-chunk quadratic term
(attention-like, masked causal inside a chunk) plus a state carried from
chunk to chunk, linear in the sequence length.  Decode updates the state
one token at a time.  The projections stay unfused (``w_z``, ``w_x``,
``w_B``, ``w_C``, ``w_dt``), with one depthwise causal conv each for x, B
and C; n_groups = 1.  No kernel runs here: the reference computes all of
it in jnp, outside any Pallas kernel, and so does the port in torch ops.

Dtypes follow the reference's promotion step by step.  The training conv
adds tap by tap in its input's dtype, then adds the float32 bias (so a
bf16 input leaves the conv as float32); decode's conv is one product over
the window in the cache's dtype.  ``dt`` and the SSD sums are float32,
``y`` returns to the head inputs' dtype, and ``out_proj``'s product to the
block input's (:func:`repro_torch.models.layers.mm`'s rule).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mm, rmsnorm


def ssm_dims(cfg) -> tuple[int, int]:
    """(d_inner, number of SSD heads)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` spelled as the reference's ``jax.nn.softplus``
    (``logaddexp(x, 0)``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv. x (B,S,C), w (K,C), b (C): tap by tap in the
    promoted dtype of x and w, then ``+ b`` (promoting once more)."""
    k = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xi * w[i]
    return out + b


def ssd_chunked(xh, dt, a_neg, bmat, cmat, chunk: int = 128,
                initial_state=None, return_state: bool = False):
    """Chunked SSD scan.

    xh (B,S,H,P) head inputs; dt (B,S,H) post-softplus; a_neg (H,)
    negative; bmat/cmat (B,S,N) (n_groups = 1, broadcast over heads).
    Returns (y (B,S,H,P) in xh's dtype, final state (B,H,P,N) float32 or
    None).  S must be a multiple of ``chunk`` (ValueError otherwise).

    One divergence from the reference, a repair: the intra-chunk decay
    ``exp(cum_i - cum_j)`` is masked *before* the exponential (j > i gets
    ``-inf``, so 0), where the reference exponentiates every (i, j) and
    zeroes j > i after.  For j > i that exponent is positive and overflows
    float32 once a chunk's summed ``dt * |a|`` passes ~88.7 (at chunk 128,
    a = -1 and dt = softplus(N(0, 1)) it sums to ~110); the reference's
    forward drops the infs, but its backward multiplies them by 0 and
    returns NaN for dt.  Here the decay is the reference's entry for entry
    (the same exponent gives the same value, a masked entry is 0 either
    way); the gradients equal the reference's wherever those are finite,
    and stay finite where they are NaN.

    The reference's inter-chunk ``lax.scan`` is a loop over chunks that
    keeps the state *before* each chunk.
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0: the SSD scan needs "
                         "whole chunks")
    nc = s // chunk
    f32 = torch.float32
    xc = xh.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    bc = bmat.reshape(b, nc, chunk, n).to(f32)
    cc = cmat.reshape(b, nc, chunk, n).to(f32)

    da = dtc * a_neg                                        # (B,nc,Q,H) <= 0
    cum = torch.cumsum(da, dim=2)                           # running log-decay
    seg_end = cum[:, :, -1:, :]                             # (B,nc,1,H)

    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i.B_j) x_j
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)            # (B,nc,Q,Q)
    w_ij = cb[..., None] * decay * dtc[:, :, None, :, :]    # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xc)

    # chunk states: S_c = sum_j exp(seg_end - cum_j) dt_j B_j (x) x_j
    state_w = torch.exp(seg_end - cum) * dtc                # (B,nc,Q,H)
    states = torch.einsum("bcqhp,bcqn->bchpn", xc * state_w[..., None], bc)

    # inter-chunk recurrence over the chunks
    seg_decay = torch.exp(seg_end[:, :, 0, :])              # (B,nc,H)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)                                  # state BEFORE c
        state = state * seg_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    # y_inter_i = exp(cum_i) * C_i . S_prev
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, prev_states) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(xh.dtype), (state if return_state else None)


def _project(x, w, ch=slice(None), heads=slice(None)):
    """The unfused projections and the three depthwise convs of ``x``:
    (z, xi, bmat, cmat, dt), from the mixer's weights ``w`` (a module, or
    ``w(name)`` giving a rank's shards) and the slices ``ch`` / ``heads``
    of its per-channel and per-head ones."""
    if isinstance(w, torch.nn.Module):
        w = functools.partial(getattr, w)
    z = mm(x, w("w_z"))
    xi = causal_conv1d(mm(x, w("w_x")), w("conv_x"), w("conv_bx")[ch])
    bmat = causal_conv1d(mm(x, w("w_B")), w("conv_B"), w("conv_bB"))
    cmat = causal_conv1d(mm(x, w("w_C")), w("conv_C"), w("conv_bC"))
    xi, bmat, cmat = F.silu(xi), F.silu(bmat), F.silu(cmat)
    dt = softplus(mm(x, w("w_dt")).to(torch.float32) + w("dt_bias")[heads])
    return z, xi, bmat, cmat, dt


#: The mixer's weights split over ``model`` by their head or channel dim
#: (``parallel.sharding.param_spec``); the rest are replicated there.
_SPLIT = ("w_z", "w_x", "w_dt", "conv_x", "out_proj")


def _head_split(p, cfg):
    """(split, rank, heads this rank runs) of a mixer: split where the
    weights of :data:`_SPLIT` are DTensors sharded over ``model`` (the
    reference's ``ssm_heads`` rule), all or none of them; else every
    head on rank 0."""
    from repro_torch.parallel import local as tp

    _, n_heads = ssm_dims(cfg)
    split = {name: tp.split_over_model(getattr(p, name)) for name in _SPLIT}
    if len(set(split.values())) > 1:
        raise ValueError(f"the SSD heads split over model by some weights "
                         f"and not others: {split}")
    if not split["w_x"]:
        return False, 0, n_heads
    mesh = p.w_x.device_mesh
    m = tp.axis_size(mesh, tp.MODEL)
    return True, tp.axis_rank(mesh, tp.MODEL), n_heads // m


def _gated_norm(y, z, w, width: int, group):
    """``rmsnorm(y * silu(z), w)`` over ``width`` channels of which this
    rank holds ``y``'s: the sum of squares summed over ``group`` (one
    all-reduce of (B, S)), whose readers are each rank's own channels."""
    from repro_torch.parallel import local as tp

    x = y * F.silu(z)
    if group is None:
        return rmsnorm(x, w)
    x32 = x.to(torch.float32)
    ss = tp.reduce(torch.sum(x32 * x32, dim=-1, keepdim=True), group,
                   grad="sum")
    return (x32 * torch.rsqrt(ss / width + 1e-6) * w).to(x.dtype)


def mamba2_block(x, p, cfg, chunk: int = 128, return_state: bool = False):
    """The Mamba-2 mixer. x (B,S,D) -> (B,S,D) [, final SSD state
    (B,H,P,N)].

    Weights split over ``model`` (DTensors, ``ssm_heads`` as the
    reference's ``src/repro/models/ssm.py:53-91`` lays them out) run
    head-parallel: each rank runs its own SSD heads on its local rows of a
    DTensor ``x`` (the residual stream: its batch over the data axes),
    from its shards of the split weights and its heads' slice of the
    replicated per-head and per-channel ones (``a_log``, ``dt_bias``,
    ``d_skip``, ``conv_bx``, ``norm_w``); ``w_B`` and ``w_C`` stay whole,
    as the state is one group.  The gated norm sums its squares over the
    ranks and ``out_proj``'s partial products are summed once; the output
    comes back laid out as ``x`` and the final state as a DTensor of this
    rank's heads.  Unsplit, the heads are all H and every collective is
    the identity."""
    from repro_torch.parallel import local as tp

    d_inner, n_heads = ssm_dims(cfg)
    split, rank, hl = _head_split(p, cfg)
    group = tp.model_group(p.w_x)
    pd = cfg.ssm_headdim
    heads = slice(rank * hl, (rank + 1) * hl)
    ch = slice(rank * hl * pd, (rank + 1) * hl * pd)

    def w(name):
        return tp.local_param(getattr(p, name), x, split)

    xl = tp.local_input(x, split)
    b, s, _ = xl.shape
    z, xi, bmat, cmat, dt = _project(xl, w, ch, heads)
    a_neg = -torch.exp(w("a_log")[heads].to(torch.float32))
    xh = xi.reshape(b, s, hl, pd)
    y, state = ssd_chunked(xh, dt, a_neg, bmat, cmat, chunk=chunk,
                           return_state=return_state)
    y = y + xh * w("d_skip")[heads][None, None, :, None].to(xh.dtype)
    y = _gated_norm(y.reshape(b, s, hl * pd), z, w("norm_w")[ch], d_inner,
                    group)
    out = tp.like(tp.reduce(mm(y, w("out_proj")).to(xl.dtype), group), x)
    if not return_state:
        return out
    return out, _heads_dtensor(state, x, split, n_heads)


def _heads_dtensor(state, x, split: bool, n_heads: int):
    """This rank's SSD state (B_l, H_l, P, N) as a DTensor: the batch laid
    out as DTensor ``x``'s, the heads over ``model`` where split; the
    state itself beside a plain ``x``."""
    if not hasattr(x, "placements"):
        return state
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.parallel import local as tp

    mesh = x.device_mesh
    pl = tuple(Shard(1) if name == tp.MODEL and split
               else (Shard(0) if name != tp.MODEL and xp.is_shard(0)
                     else Replicate())
               for name, xp in zip(mesh.mesh_dim_names, x.placements))
    shape = (x.shape[0], n_heads, *state.shape[2:])
    return DTensor.from_local(state, mesh, pl, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def conv_inputs(x, p) -> torch.Tensor:
    """The raw x | B | C projections stacked on the last axis, before the
    conv: what the conv cache holds."""
    return torch.cat([mm(x, p.w_x), mm(x, p.w_B), mm(x, p.w_C)], dim=-1)


def mamba2_decode(x, p, cfg, conv_state, ssd_state):
    """One-token decode. x (B,1,D); conv_state (B,K-1,C_all) (the last K-1
    raw projections); ssd_state (B,H,P,N).  C_all = d_inner + 2N (x | B |
    C stacked).  Returns (y (B,1,D), conv_state, ssd_state), both states
    new tensors.

    With weights split over ``model`` (a sharded decode step on local
    rows), each rank runs its own heads over its heads' channels of the
    conv window: ssd_state is this rank's heads' (the ``ssd`` entry of
    ``cache_pspecs``), the conv cache stays whole (the new column's
    channels gathered), and the output's partial products are summed
    once; unsplit, every collective is the identity."""
    from repro_torch.parallel import local as tp

    d_inner, _ = ssm_dims(cfg)
    n, pd = cfg.ssm_state, cfg.ssm_headdim
    split, rank, hl = _head_split(p, cfg)
    group = tp.model_group(p.w_x)
    heads = slice(rank * hl, (rank + 1) * hl)
    ch = slice(rank * hl * pd, (rank + 1) * hl * pd)

    def w(name):
        return tp.local_param(getattr(p, name), x, split)

    x0 = x[:, 0]
    z = mm(x0, w("w_z"))
    new_col = torch.cat([tp.gather(mm(x0, w("w_x")), group, dim=-1),
                         mm(x0, w("w_B")), mm(x0, w("w_C"))], dim=-1)
    dt_win = torch.promote_types(conv_state.dtype, new_col.dtype)
    window = torch.cat([conv_state.to(dt_win), new_col[:, None].to(dt_win)],
                       dim=1)                               # (B,K,C_all)
    conv_state = window[:, 1:]
    if split:                   # this rank's channels of x, then B and C
        window = torch.cat([window[..., :d_inner][..., ch],
                            window[..., d_inner:]], dim=-1)
    conv_w = torch.cat([w("conv_x"), w("conv_B"), w("conv_C")], dim=1)
    conv_b = torch.cat([w("conv_bx")[ch], w("conv_bB"), w("conv_bC")])
    dt_mul = torch.promote_types(window.dtype, conv_w.dtype)
    col = torch.einsum("bkc,kc->bc", window.to(dt_mul), conv_w.to(dt_mul)) \
        + conv_b
    col = F.silu(col)
    dil = hl * pd
    xi = col[:, :dil]
    bmat = col[:, dil:dil + n].to(torch.float32)
    cmat = col[:, dil + n:].to(torch.float32)
    dt = softplus(mm(x0, w("w_dt")).to(torch.float32) + w("dt_bias")[heads])
    a_neg = -torch.exp(w("a_log")[heads].to(torch.float32))
    xh = xi.reshape(-1, hl, pd).to(torch.float32)
    decay = torch.exp(dt * a_neg)                           # (B,H)
    upd = (dt[:, :, None] * xh)[..., None] * bmat[:, None, None, :]
    ssd_state = ssd_state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", ssd_state, cmat)
    y = y + xh * w("d_skip")[heads][None, :, None]
    y = y.reshape(-1, dil).to(x.dtype)
    y = _gated_norm(y, z, w("norm_w")[ch], d_inner, group)
    return tp.reduce(mm(y, w("out_proj")), group)[:, None], conv_state, \
        ssd_state
