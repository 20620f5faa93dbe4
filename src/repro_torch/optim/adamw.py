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
shards, element for element the unsharded arithmetic.

8-bit moments of a split parameter keep the unsharded moments' bits: the
reference quantizes the whole moment array, so each rank quantizes its
shard's blocks with their global block indices (:func:`moment_offset`:
``row0`` and, for a column split, the stride of its local rows among the
global ones), and the SR noise is the global element's.  A split whose
local runs are not whole blocks of ``state_group`` would straddle the
shards, and raises, naming the parameter and its shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backend
from repro_torch.core.prng import MASK32
from repro_torch.obs.trace import span


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
def _q_state(x: torch.Tensor, bits: int, group: int, seed: int,
             offset=(0, None)) -> dict:
    """``x`` block-quantized: packed words ``p``, ``z`` (zero) and ``r``
    (range) per block (the kernels on the card, the plain version on the
    CPU); ``offset`` (row0, block_stride) places a shard's blocks among
    the whole moment's (:func:`moment_offset`)."""
    blocks, _ = backend.to_blocks(x, group)
    p, z, r = backend.quantize_blocks(blocks, bits, int(seed) & MASK32,
                                      row0=offset[0],
                                      block_stride=offset[1])
    return {"p": p, "z": z, "r": r}


def moment_offset(shape, local_shape, offset, group: int) -> tuple:
    """``(row0, block_stride)`` of a shard's moment blocks among the
    unsharded moment's (``quant_pack``'s offset arguments), from the
    parameter's global ``shape``, its shard's ``local_shape`` and the
    shard's global ``offset`` (one entry a dim); ``(0, None)`` for a
    parameter that is not split.

    Past the last split dim k the shard holds whole rows, so the shard is
    runs of ``L = local[k] * prod(shape[k+1:])`` contiguous elements of the
    unsharded array, one a local index of the dims before k, ``shape[k] *
    prod(shape[k+1:])`` apart.  Raises ValueError where a run is not whole
    blocks of ``group`` (a block would straddle the shards) or the runs
    are not evenly spaced (a split dim before k with a dim between it and
    k that is split too)."""
    shape, local_shape = tuple(shape), tuple(local_shape)
    cut = [i for i, (a, b) in enumerate(zip(local_shape, shape)) if a != b]
    if not cut:
        return 0, None
    k = cut[-1]
    inner = 1
    for d in shape[k + 1:]:
        inner *= d
    run, row = local_shape[k] * inner, shape[k] * inner
    if run % group:
        raise ValueError(
            f"a shard of {local_shape} of a {shape} moment: its runs of "
            f"{run} elements straddle blocks of {group}")
    base = offset[k] * inner
    for i in range(k):
        lstride = gstride = 1
        for j in range(i + 1, k):
            lstride, gstride = lstride * local_shape[j], gstride * shape[j]
        if local_shape[i] > 1 and lstride != gstride:
            raise ValueError(f"a shard of {local_shape} of a {shape} "
                             "moment is not evenly spaced runs")
        base += offset[i] * gstride * row
    runs = 1
    for d in local_shape[:k]:
        runs *= d
    stride = None if runs == 1 or run == row else (run // group,
                                                   row // group)
    return base // group, stride


def shard_offset(p, group: int) -> tuple:
    """:func:`moment_offset` of parameter ``p`` (a DTensor, on any device
    ``meta`` included; ``(0, None)`` for a plain tensor)."""
    if not hasattr(p, "placements"):
        return 0, None
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(
        tuple(p.shape), p.device_mesh, p.placements)
    return moment_offset(p.shape, local, offset, group)


def _dq_state(s: dict, bits: int, group: int, shape) -> torch.Tensor:
    return backend.from_blocks(backend.dequantize_blocks(
        s["p"], s["z"], s["r"], bits, group), tuple(shape))


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
    # DTensor's shards of an uneven dim are torch.chunk's: each padded to
    # the first's length for the gather, then cut back
    sizes = [len(c) for c in torch.arange(g.shape[dim]).chunk(n)]
    sizes += [0] * (n - len(sizes))
    local = g.to_local().movedim(dim, 0)
    width = sizes[0]
    if local.shape[0] < width:
        local = torch.cat([local, local.new_zeros(
            (width - local.shape[0], *local.shape[1:]))])
    local = local.contiguous()
    out = torch.empty((n * width, *local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local, group=mesh.get_group(mesh_dim))
    if any(sz != width for sz in sizes):
        out = torch.cat([out[r * width:r * width + sz]
                         for r, sz in enumerate(sizes)])
    pl[mesh_dim] = Replicate()
    full = out.movedim(0, dim).contiguous()
    return DTensor.from_local(full, mesh, tuple(pl), shape=g.shape,
                              stride=g.stride())


def _sq_norm(g) -> torch.Tensor:
    """``sum(g**2)`` in float32 over every shard of ``g``."""
    s = torch.sum(torch.square(g.float()))
    return s.full_tensor() if hasattr(s, "full_tensor") else s


def adamw_init(params, cfg: AdamWConfig | None = None, names=None) -> dict:
    """Zero moments for ``params``.  With 8-bit moments a parameter whose
    shard would straddle blocks raises ValueError naming it (``names``, one
    a parameter, e.g. ``named_parameters``' keys; else its index) and its
    shape."""
    cfg = cfg or AdamWConfig()
    params = list(params)
    offsets = [(0, None)] * len(params)
    if cfg.state_bits:
        names = list(names) if names is not None else \
            [f"parameter {i}" for i in range(len(params))]
        offsets = []
        for name, p in zip(names, params):
            try:
                offsets.append(shard_offset(p, cfg.state_group))
            except ValueError as exc:
                raise ValueError(f"8-bit moments of {name} "
                                 f"{tuple(p.shape)}: {exc}") from None

    def zero_like(p, off):
        z = torch.zeros_like(_local(p), dtype=torch.float32)
        if cfg.state_bits:
            return _q_state(z, cfg.state_bits, cfg.state_group, 0, off)
        return z.to(getattr(torch, cfg.state_dtype))

    return {"step": 0,
            "m": [zero_like(p, o) for p, o in zip(params, offsets)],
            "v": [zero_like(p, o) for p, o in zip(params, offsets)]}


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig) -> None:
    """One AdamW step over matching lists of grads and params, in place
    (quantized moment leaves are replaced by their new quantization),
    inside an ``optim/adamw`` span."""
    with span("optim/adamw"):
        step = state["step"]
        lr = float(schedule(cfg, step))
        t = np.float32(step + 1)
        grads = [placed(g, p) for g, p in zip(grads, params)]
        gnorm = torch.sqrt(sum(_sq_norm(g) for g in grads)) \
            if cfg.grad_clip else None
        grads = [_local(g) for g in grads]
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0) if cfg.grad_clip else None
        bc1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
        bits, group = cfg.state_bits, cfg.state_group
        seed = (step + 1) & MASK32
        for i, (g, m, v, p) in enumerate(zip(grads, state["m"], state["v"],
                                             params)):
            # each gradient scaled as it is read: scaled copies of every
            # gradient at once would double their memory
            off = shard_offset(p, group) if bits else None
            g, p = (g if scale is None else g * scale).float(), _local(p)
            if bits:
                m_f = _dq_state(m, bits, group, g.shape)
                v_f = torch.clamp_min(_dq_state(v, bits, group, g.shape), 0.0)
                m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
                v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
            elif m.dtype == torch.float32:
                m_f = m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
                v_f = v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            else:
                # a narrower float state: the update in float32, stored
                # rounded
                m_f = cfg.b1 * m.float() + (1 - cfg.b1) * g
                v_f = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
                m.copy_(m_f)
                v.copy_(v_f)
            upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
            if cfg.weight_decay:
                upd = upd + cfg.weight_decay * p.float()
            p.sub_((lr * upd).to(p.dtype))
            if bits:
                state["m"][i] = _q_state(m_f, bits, group, seed, off)
                state["v"][i] = _q_state(v_f, bits, group, seed + 1, off)
        state["step"] = step + 1
