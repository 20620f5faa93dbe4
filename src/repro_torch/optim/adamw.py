"""AdamW with float32 moment states (the reference's ``repro.optim.adamw``
at ``state_bits=0``).  Parameters and moments are updated in place, which
saves a copy of every leaf per step; the arithmetic is the reference's, in
the same order."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0          # 0 disables
    state_bits: int = 0             # 0 = float states (8-bit not ported yet)
    warmup_steps: int = 0
    decay_steps: int = 0            # 0 = constant lr after warmup

    def __post_init__(self):
        if self.state_bits:
            raise NotImplementedError(
                "state_bits=8 (block-quantized moments) is not ported yet")


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


def adamw_init(params) -> dict:
    return {"step": 0,
            "m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params]}


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig) -> None:
    """One AdamW step over matching lists of grads and params, in place."""
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
    for g, m, v, p in zip(grads, state["m"], state["v"], params):
        g = g.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p.float()
        p.sub_((lr * upd).to(p.dtype))
    state["step"] = step + 1
