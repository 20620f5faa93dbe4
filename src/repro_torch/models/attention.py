"""GQA attention (the reference's ``repro.models.attention``): the prefill
path through the flash-attention kernel, the training path in plain
differentiable ops, and the cached decode paths.

:func:`online_attention` computes what the reference's chunked
online-softmax scan computes.  On the card it launches the hand-written
kernel (``csrc/flash_attention.cu``), which keeps the running max, sum and
accumulator of each 64-row query tile on chip; on the CPU it runs the
kernel's plain version, a masked softmax over the full score matrix.  Both
scale q in float32 before the product, as the reference does.  The kernel
has no backward, so training attends through :func:`chunked_attention`,
the reference's ``k_chunk`` scan spelled in torch ops that autograd
differentiates (the reference computes it in jnp, outside any kernel).

Decode reads the quantized paged KV cache one page per online-softmax step
(:func:`decode_attend_paged`), as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, mm, rmsnorm
from repro_torch.parallel.annotate import shard
from repro_torch.parallel.local import plain_operand, reduce_all

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv*n_rep, Dh)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def online_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                     kv_len: int | None = None, impl: str = "auto"):
    """Streaming-softmax attention.

    q: (B, Sq, H, Dh);  k, v: (B, Skv, H, Dh) (already GQA-expanded).
    ``q_offset``: absolute position of q[0] (causal masking for chunked
    prefill).  ``kv_len``: number of valid kv entries (the cache may be
    padded).  Output (B, Sq, H, Dh) in q's dtype.  The kernel tiles keys by
    64 (the reference scans them in ``cfg.k_chunk`` chunks); the result
    agrees up to float rounding.  ``impl`` routes as
    :func:`repro_torch.kernels.ops.flash_attention` does.
    """
    b, sq, h, dh = q.shape
    # the reference's numpy-float64 scale promotes q to float32 before the
    # product: (q * scale) . k, not (q . k) * scale
    scale = float(1.0 / np.sqrt(dh))

    def heads(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], dh)

    out = ops.flash_attention(heads(q), heads(k), heads(v), causal=causal,
                              q_offset=int(q_offset), kv_len=kv_len,
                              scale=scale, scale_q=True, impl=impl)
    return out.reshape(b, h, sq, dh).transpose(1, 2)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      kv_len: int | None = None, k_chunk: int = 1024):
    """The reference's ``online_attention`` (its ``k_chunk`` scan) in
    differentiable torch ops: keys and values padded to whole chunks, one
    online-softmax step a chunk with float32 running max, sum and
    accumulator.  Shapes as :func:`online_attention`'s.  DTensor inputs
    attend shard by shard (:func:`_attend_shards`)."""
    if hasattr(q, "to_local"):
        return _attend_shards(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len, k_chunk=k_chunk)
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    scale = float(1.0 / np.sqrt(dh))
    qf = (q.to(torch.float32) * scale).transpose(1, 2)            # B,H,Sq,Dh
    kf = k.to(torch.float32).permute(0, 2, 3, 1)                  # B,H,Dh,Skv
    vf = v.to(torch.float32).transpose(1, 2)                      # B,H,Skv,Dh
    n_chunks = max(1, -(-skv // k_chunk))
    pad = n_chunks * k_chunk - skv
    if pad:
        kf = torch.nn.functional.pad(kf, (0, pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    q_pos = q_offset + torch.arange(sq, device=q.device)
    limit = kv_len if kv_len is not None else skv
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        kc = kf[..., c * k_chunk:(c + 1) * k_chunk]
        vc = vf[:, :, c * k_chunk:(c + 1) * k_chunk]
        s = torch.einsum("bhqd,bhdk->bhqk", qf, kc)
        kv_pos = c * k_chunk + torch.arange(k_chunk, device=q.device)
        mask = (kv_pos[None, :] < limit).expand(sq, k_chunk)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                        # B,Sq,H,Dh


def _attend_shards(q, k, v, *, causal: bool, q_offset: int, kv_len,
                   k_chunk: int):
    """:func:`chunked_attention` of DTensors, each rank over its own shard:
    q, k and v laid out by the reference's logical axes (batch, heads and,
    for long queries where the heads do not divide, the query positions;
    k and v whole along the keys), then the scan on the local tensors
    with the query shard's global offset.  The scan's operands and its
    running max, sum and accumulator so keep the layout the reference's
    ``shard`` sites give them (``src/repro/models/attention.py:44-46,
    61, 77-85``), and no op of the scan crosses a shard, so none sends
    anything; torch 2.11's DTensor cannot flatten the batch and a sharded
    head dim for the scan's batched products, and this keeps the scan out
    of DTensor.  Raises where k and v are not laid out as q (a layout the
    rules never give)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    sp = "q_seq" if q.shape[1] >= 2048 else None
    q = shard(q, "batch", sp, "heads", None)
    k = shard(k, "batch", None, "heads", None)
    v = shard(v, "batch", None, "heads", None)
    want = tuple(p for p in q.placements)
    for name, t in (("k", k), ("v", v)):
        ok = all(tp == qp or (qp.is_shard(1) and tp.is_replicate())
                 for tp, qp in zip(t.placements, want))
        if not ok or any(p.is_partial() or p.is_shard(3) for p in want):
            raise ValueError(f"attention shards: q {want}, {name} "
                             f"{t.placements}")
    _, offset = compute_local_shape_and_global_offset(
        tuple(q.shape), q.device_mesh, want)
    from repro_torch.parallel.local import contiguous_grad

    out = chunked_attention(*(contiguous_grad(t.to_local())
                              for t in (q, k, v)),
                            causal=causal, q_offset=q_offset + offset[1],
                            kv_len=kv_len, k_chunk=k_chunk).contiguous()
    return DTensor.from_local(out, q.device_mesh, want, shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())


def _split_heads(t, n: int, d_head: int, flat: str, heads: str):
    """(B, S, n*d_head) -> (B, S, n, d_head).  Where the rules split the
    flattened dim (logical axis ``flat``) but not the heads (``heads``:
    the head count does not divide the axis), the flattened dim is
    gathered first: DTensor cannot cut a split dim into heads the split
    does not fall between (the reference's GSPMD reshards there)."""
    from repro_torch.parallel.annotate import spec_of

    if spec_of(flat)[0] is not None and spec_of(heads)[0] is None:
        t = shard(t, "batch", None, None)
    return t.reshape(*t.shape[:2], n, d_head)


def qkv_project(x, p, cfg, positions):
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S,Hkv,Dh) with rope + qk-norm.
    ``p`` holds the layer's attention weights (``wq``, ``wk``, ``wv``, and
    ``bq``/``bk``/``bv``, ``q_norm``/``k_norm`` where the config has them).
    A plain ``x`` beside DTensor weights (a sharded decode step's local
    rows) gets every head whole on every rank
    (:func:`repro_torch.parallel.local.matmul`)."""
    q = shard(mm(x, p.wq), "batch", None, "attn_out")
    k = shard(mm(x, p.wk), "batch", None, "kv_out")
    v = shard(mm(x, p.wv), "batch", None, "kv_out")
    q = _split_heads(q, cfg.n_heads, cfg.d_head, "attn_out", "heads")
    k = _split_heads(k, cfg.n_kv_heads, cfg.d_head, "kv_out", "kv_heads")
    v = _split_heads(v, cfg.n_kv_heads, cfg.d_head, "kv_out", "kv_heads")
    if cfg.qkv_bias:
        bq, bk, bv = (plain_operand(b, x) for b in (p.bq, p.bk, p.bv))
        q = q + bq.reshape(1, 1, cfg.n_heads, cfg.d_head).to(q.dtype)
        k = k + bk.reshape(1, 1, cfg.n_kv_heads, cfg.d_head).to(k.dtype)
        v = v + bv.reshape(1, 1, cfg.n_kv_heads, cfg.d_head).to(v.dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    return q, k, v


def attention_block(x, p, cfg, *, causal=True, k_chunk: int = 1024):
    """Full-sequence attention for training, through
    :func:`chunked_attention` (differentiable); prefill attends through
    :func:`online_attention`, the kernel on the card."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = qkv_project(x, p, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = chunked_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                            causal=causal, k_chunk=k_chunk)
    out = shard(out.reshape(b, s, cfg.n_heads * cfg.d_head), "batch", None,
                "attn_out")
    return mm(out, p.wo)


def cross_attention_block(x, p, cfg, enc_out, *, online: bool = False,
                          impl: str = "auto"):
    """Decoder-to-encoder attention: queries from x (B,S,D), keys and
    values projected from ``enc_out`` (B,Se,D), no rope on either, no
    mask.  Training attends through :func:`chunked_attention`
    (differentiable); ``online=True`` (decode, under ``no_grad``) through
    :func:`online_attention`, the kernel on the card (non-causal, Sq !=
    Skv: a decode step's Sq is 1), routed by ``impl``."""
    b, s, _ = x.shape
    q = shard(mm(x, p.wq), "batch", None, "attn_out")
    k = shard(mm(enc_out, p.wk), "batch", None, "kv_out")
    v = shard(mm(enc_out, p.wv), "batch", None, "kv_out")
    q = shard(_split_heads(q, cfg.n_heads, cfg.d_head, "attn_out", "heads"),
              "batch", None, "heads", None)
    k = shard(_split_heads(k, cfg.n_kv_heads, cfg.d_head, "kv_out",
                           "kv_heads"), "batch", None, "kv_heads", None)
    v = shard(_split_heads(v, cfg.n_kv_heads, cfg.d_head, "kv_out",
                           "kv_heads"), "batch", None, "kv_heads", None)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if online:
        out = online_attention(q, k, v, causal=False, impl=impl)
    else:
        out = chunked_attention(q, k, v, causal=False, k_chunk=1024)
    out = shard(out.reshape(b, s, cfg.n_heads * cfg.d_head), "batch", None,
                "attn_out")
    return mm(out, p.wo)


def _grouped_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """q (B,1,Hq,Dh) -> float32 (B,Hkv,G,Dh), scaled as the reference
    scales it (float32 q times the float32 scale)."""
    b, _, hq, dh = q.shape
    scale = torch.full((), 1.0 / np.sqrt(dh), dtype=torch.float32,
                       device=q.device)
    return (q.to(torch.float32) * scale).reshape(b, hkv, hq // hkv, dh)


def decode_attend(q, kf, vf, pos, *, out_dtype, seq=(0, ())):
    """Single-token grouped-head attention over a materialized KV window.

    q (B,1,Hq,Dh) (rope applied); kf/vf (B,S,Hkv,Dh) float32 (the window
    may be padded past ``pos``); pos (B,) integer, entries with index > pos
    mask out.  Returns (B, 1, Hq*Dh) in ``out_dtype`` (before ``wo``).

    ``seq`` (s0, groups): the window is positions ``s0 ..`` of a sequence
    split over ``groups`` (a cache laid out by ``cache_pspecs``): one max
    all-reduce gives the softmax's max, and two sum all-reduces its sum
    and the output (log-sum-exp).  Unsplit, ``(0, ())``."""
    s0, groups = seq
    b, _, hq, dh = q.shape
    hkv, smax = kf.shape[2], kf.shape[1]
    qg = _grouped_q(q, hkv)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)            # (B,Hkv,G,S)
    kv_pos = s0 + torch.arange(smax, device=q.device)
    valid = kv_pos[None, :] <= pos[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = reduce_all(s.amax(-1, keepdim=True), groups, "max")
    pexp = torch.exp(s - m)
    l = reduce_all(pexp.sum(-1, keepdim=True), groups)
    out = reduce_all(torch.einsum("bkgs,bskd->bkgd", pexp / l, vf), groups)
    return out.reshape(b, 1, hq * dh).to(out_dtype)


def decode_attend_paged(q, pos, n_chunks: int, fetch_chunk, *,
                        n_kv_heads: int, out_dtype):
    """Single-token online-softmax attention over lazily fetched KV chunks.

    The serving engine's quantized paged KV cache reads through this:
    ``fetch_chunk(j) -> (kf, vf, kv_pos)`` with kf/vf (B,C,Hkv,Dh) float32
    and kv_pos (C,) absolute positions; the caller dequantizes exactly one
    page a step, so no other page's float32 K/V exists at the same time.
    Chunk 0 must hold position 0 (valid for every slot), so the running
    max is finite after the first step and a masked score adds exactly 0.
    Returns (B, 1, Hq*Dh) in ``out_dtype`` (before ``wo``).
    """
    b, _, hq, dh = q.shape
    hkv = n_kv_heads
    g = hq // hkv
    qg = _grouped_q(q, hkv)                                  # (B,Hkv,G,Dh)
    pos = pos[:, None, None, None]
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, dh), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        kf, vf, kv_pos = fetch_chunk(j)
        s = torch.matmul(qg, kf.permute(0, 2, 3, 1))         # (B,Hkv,G,C)
        s = torch.where(kv_pos <= pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, vf.transpose(1, 2))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, hq * dh).to(out_dtype)


def attention_decode(x, p, cfg, cache_k, cache_v, pos, *, seq=(0, ())):
    """One-token decode. x (B,1,D); cache (B,Smax,Hkv,Dh); pos (B,) integer.

    Projects q/k/v, writes the new KV row at ``pos`` (in place: the port
    updates the cache tensors where the reference returns new ones; a
    position past the end clamps to the last row, as the reference's
    ``dynamic_update_slice`` clamps), and attends via :func:`decode_attend`.
    Returns (out (B,1,D), cache_k, cache_v).

    ``seq`` (s0, groups): the cache holds positions ``s0 ..`` of a
    sequence split over ``groups`` (see :func:`decode_attend`); only the
    rank whose slice holds ``pos`` writes the row, at its local index.
    """
    s0, groups = seq
    q, k, v = qkv_project(x, p, cfg, pos[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    s_local = cache_k.shape[1]
    n_split = 1
    for g in groups:
        n_split *= dist.get_world_size(g)
    at = pos.clamp(max=s_local * n_split - 1) - s0
    own = ((at >= 0) & (at < s_local))[:, None, None]
    at = at.clamp(0, s_local - 1)
    cache_k[rows, at] = torch.where(own, k[:, 0].to(cache_k.dtype),
                                    cache_k[rows, at])
    cache_v[rows, at] = torch.where(own, v[:, 0].to(cache_v.dtype),
                                    cache_v[rows, at])
    out = decode_attend(q, cache_k.to(torch.float32),
                        cache_v.to(torch.float32), pos, out_dtype=x.dtype,
                        seq=seq)
    return mm(out, p.wo), cache_k, cache_v
