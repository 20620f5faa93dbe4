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


def adamw_init(params, cfg: AdamWConfig | None = None) -> dict:
    cfg = cfg or AdamWConfig()

    def zero_like(p):
        z = torch.zeros_like(p, dtype=torch.float32)
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
    if cfg.grad_clip:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = [g * scale for g in grads]
    bc1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
    bits, group = cfg.state_bits, cfg.state_group
    seed = (step + 1) & MASK32
    for i, (g, m, v, p) in enumerate(zip(grads, state["m"], state["v"],
                                         params)):
        g = g.float()
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
