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


def _project(x, p, cfg):
    """Unfused projections and the three depthwise convs."""
    z = mm(x, p.w_z)
    xi = causal_conv1d(mm(x, p.w_x), p.conv_x, p.conv_bx)
    bmat = causal_conv1d(mm(x, p.w_B), p.conv_B, p.conv_bB)
    cmat = causal_conv1d(mm(x, p.w_C), p.conv_C, p.conv_bC)
    xi, bmat, cmat = F.silu(xi), F.silu(bmat), F.silu(cmat)
    dt = softplus(mm(x, p.w_dt).to(torch.float32) + p.dt_bias)
    return z, xi, bmat, cmat, dt


def mamba2_block(x, p, cfg, chunk: int = 128, return_state: bool = False):
    """The Mamba-2 mixer. x (B,S,D) -> (B,S,D) [, final SSD state]."""
    d_inner, n_heads = ssm_dims(cfg)
    z, xi, bmat, cmat, dt = _project(x, p, cfg)
    a_neg = -torch.exp(p.a_log.to(torch.float32))
    xh = xi.reshape(*xi.shape[:2], n_heads, cfg.ssm_headdim)
    y, state = ssd_chunked(xh, dt, a_neg, bmat, cmat, chunk=chunk,
                           return_state=return_state)
    y = y + xh * p.d_skip[None, None, :, None].to(xh.dtype)
    y = y.reshape(*x.shape[:2], d_inner)
    y = rmsnorm(y * F.silu(z), p.norm_w)
    out = mm(y, p.out_proj).to(x.dtype)
    return (out, state) if return_state else out


def conv_inputs(x, p) -> torch.Tensor:
    """The raw x | B | C projections stacked on the last axis, before the
    conv: what the conv cache holds."""
    return torch.cat([mm(x, p.w_x), mm(x, p.w_B), mm(x, p.w_C)], dim=-1)


def mamba2_decode(x, p, cfg, conv_state, ssd_state):
    """One-token decode. x (B,1,D); conv_state (B,K-1,C_all) (the last K-1
    raw projections); ssd_state (B,H,P,N).  C_all = d_inner + 2N (x | B |
    C stacked).  Returns (y (B,1,D), conv_state, ssd_state), both states
    new tensors."""
    d_inner, n_heads = ssm_dims(cfg)
    n = cfg.ssm_state
    x0 = x[:, 0]
    z = mm(x0, p.w_z)
    new_col = conv_inputs(x0, p)
    dt_win = torch.promote_types(conv_state.dtype, new_col.dtype)
    window = torch.cat([conv_state.to(dt_win), new_col[:, None].to(dt_win)],
                       dim=1)                               # (B,K,C_all)
    conv_state = window[:, 1:]
    conv_w = torch.cat([p.conv_x, p.conv_B, p.conv_C], dim=1)
    conv_b = torch.cat([p.conv_bx, p.conv_bB, p.conv_bC])
    dt_mul = torch.promote_types(window.dtype, conv_w.dtype)
    col = torch.einsum("bkc,kc->bc", window.to(dt_mul), conv_w.to(dt_mul)) \
        + conv_b
    col = F.silu(col)
    xi = col[:, :d_inner]
    bmat = col[:, d_inner:d_inner + n].to(torch.float32)
    cmat = col[:, d_inner + n:].to(torch.float32)
    dt = softplus(mm(x0, p.w_dt).to(torch.float32) + p.dt_bias)
    a_neg = -torch.exp(p.a_log.to(torch.float32))
    xh = xi.reshape(-1, n_heads, cfg.ssm_headdim).to(torch.float32)
    decay = torch.exp(dt * a_neg)                           # (B,H)
    upd = (dt[:, :, None] * xh)[..., None] * bmat[:, None, None, :]
    ssd_state = ssd_state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", ssd_state, cmat)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(-1, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.norm_w)
    return mm(y, p.out_proj)[:, None], conv_state, ssd_state
