"""AdamW with float or 8-bit block-wise moment states (the reference's
``repro.optim.adamw``).

``state_bits=8`` stores the first and second moments with the same
block-wise stochastic-rounding quantizer the paper applies to activations
(blocks of ``state_group``, uniform levels), 4x less state memory.  The
states are re-quantized every step with a step-derived SR seed (``step +
1`` for ``m``, ``step + 2`` for ``v``, the same for every leaf), so
rounding errors stay zero-mean instead of accumulating.  On the card the
moments go through the ``quant_pack`` / ``dequant_unpack`` kernels, whose
words, zero and range are the plain path's bit for bit.

Float states (``state_bits=0``) are kept in ``state_dtype``; float32
moments and the parameters are updated in place, which saves a copy of
every leaf per step.  The arithmetic is the reference's, in the same order.

Parameters may be DTensors (a sharded LM, :mod:`repro_torch.parallel.
sharding`).  A gradient comes back from autograd in whatever placement
DTensor's rules left it (a partial sum, or replicated at full shape), so
each is first redistributed to its parameter's placements; the clip norm
is the global norm over every shard; the update then runs on the local
shards, element for element the unsharded arithmetic.  8-bit moments of a
parameter split over more than one rank are not supported: their blocks
of ``state_group`` would straddle the shards.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backend
from repro_torch.core.prng import MASK32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0          # 0 disables
    state_bits: int = 0             # 0 = float states; 8 = block-wise int8
    state_group: int = 256
    state_dtype: str = "float32"    # float moment dtype when state_bits == 0
    warmup_steps: int = 0
    decay_steps: int = 0            # 0 = constant lr after warmup


def schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """Linear warmup then (optional) cosine decay, in float32."""
    s = np.float32(step)
    lr = np.float32(cfg.lr)
    if cfg.warmup_steps:
        lr = lr * np.minimum(np.float32(1.0),
                             (s + np.float32(1)) / np.float32(cfg.warmup_steps))
    if cfg.decay_steps:
        frac = np.clip((s - np.float32(cfg.warmup_steps))
                       / np.float32(cfg.decay_steps), 0.0, 1.0)
        lr = lr * np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi)
                                                             * frac))
    return np.float32(lr)


# -------------------------------------------------- quantized state leaves
def _q_state(x: torch.Tensor, bits: int, group: int, seed: int) -> dict:
    """``x`` block-quantized: packed words ``p``, ``z`` (zero) and ``r``
    (range) per block (the kernels on the card, the plain version on the
    CPU)."""
    blocks, _ = backend.to_blocks(x, group)
    p, z, r = backend.quantize_blocks(blocks, bits, int(seed) & MASK32)
    return {"p": p, "z": z, "r": r}


def _dq_state(s: dict, bits: int, group: int, shape) -> torch.Tensor:
    return backend.from_blocks(backend.dequantize_blocks(
        s["p"], s["z"], s["r"], bits, group), tuple(shape))


def _is_split(p) -> bool:
    """True for a DTensor split over more than one rank."""
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor) and any(
        pl.is_shard() and p.device_mesh.size(i) > 1
        for i, pl in enumerate(p.placements))


def _local(t):
    """A DTensor's local shard (a plain tensor as it is)."""
    return t.to_local() if hasattr(t, "to_local") else t


def placed(g, p):
    """Gradient ``g`` in parameter ``p``'s placements (a collective where
    they differ; plain tensors as they are).  Along a mesh dim where ``g``
    comes back sharded and ``p`` is replicated (a bias added to
    head-sharded activations), the shards are gathered with the blocking
    ``all_gather_into_tensor`` of that dim's group: DTensor's own gather is
    the functional collective, which gloo on CUDA tensors does not survive
    (torch 2.11: the rank segfaults); every other move is DTensor's."""
    if not hasattr(p, "placements"):
        return g
    for i, (gp, pp) in enumerate(zip(g.placements, p.placements)):
        if gp.is_shard() and pp.is_replicate():
            g = _gather(g, i)
    if tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _gather(g, mesh_dim: int):
    """DTensor ``g`` replicated along ``mesh_dim``, where it is sharded."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    mesh, pl = g.device_mesh, list(g.placements)
    dim, n = pl[mesh_dim].dim, mesh.size(mesh_dim)
    if g.shape[dim] % n:
        raise ValueError(f"gathering an uneven shard of {tuple(g.shape)}")
    local = g.to_local().movedim(dim, 0).contiguous()
    out = torch.empty((n * local.shape[0], *local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local, group=mesh.get_group(mesh_dim))
    pl[mesh_dim] = Replicate()
    full = out.movedim(0, dim).contiguous()
    return DTensor.from_local(full, mesh, tuple(pl), shape=g.shape,
                              stride=g.stride())


def _sq_norm(g) -> torch.Tensor:
    """``sum(g**2)`` in float32 over every shard of ``g``."""
    s = torch.sum(torch.square(g.float()))
    return s.full_tensor() if hasattr(s, "full_tensor") else s


def adamw_init(params, cfg: AdamWConfig | None = None) -> dict:
    cfg = cfg or AdamWConfig()
    if cfg.state_bits and any(_is_split(p) for p in params):
        raise NotImplementedError(
            "8-bit AdamW moments of a parameter sharded over more than one "
            "rank (their blocks straddle the shards) come in port slice 19")

    def zero_like(p):
        z = torch.zeros_like(_local(p), dtype=torch.float32)
        if cfg.state_bits:
            return _q_state(z, cfg.state_bits, cfg.state_group, 0)
        return z.to(getattr(torch, cfg.state_dtype))

    return {"step": 0, "m": [zero_like(p) for p in params],
            "v": [zero_like(p) for p in params]}


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig) -> None:
    """One AdamW step over matching lists of grads and params, in place
    (quantized moment leaves are replaced by their new quantization)."""
    step = state["step"]
    lr = float(schedule(cfg, step))
    t = np.float32(step + 1)
    grads = [placed(g, p) for g, p in zip(grads, params)]
    gnorm = torch.sqrt(sum(_sq_norm(g) for g in grads)) \
        if cfg.grad_clip else None
    grads = [_local(g) for g in grads]
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = [g * scale for g in grads]
    bc1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
    bits, group = cfg.state_bits, cfg.state_group
    seed = (step + 1) & MASK32
    for i, (g, m, v, p) in enumerate(zip(grads, state["m"], state["v"],
                                         params)):
        g, p = g.float(), _local(p)
        if bits:
            m_f = _dq_state(m, bits, group, g.shape)
            v_f = torch.clamp_min(_dq_state(v, bits, group, g.shape), 0.0)
            m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
            v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        elif m.dtype == torch.float32:
            m_f = m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v_f = v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        else:   # a narrower float state: the update in float32, stored rounded
            m_f = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v_f = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            m.copy_(m_f)
            v.copy_(v_f)
        upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p.float()
        p.sub_((lr * upd).to(p.dtype))
        if bits:
            state["m"][i] = _q_state(m_f, bits, group, seed)
            state["v"][i] = _q_state(v_f, bits, group, seed + 1)
    state["step"] = step + 1
