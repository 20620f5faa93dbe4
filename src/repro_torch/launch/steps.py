"""Step functions the launchers and tests drive (the reference's
``repro.launch.steps``): train (with gradient accumulation), prefill and
decode.  The model's parameters and the optimizer state are updated in
place, where the reference returns new ones.

A model whose parameters are DTensors (``parallel.sharding.distribute_
model``) trains sharded through the same step: DTensor's implicit
replication is on for the step, so the model's plain constants (positions,
masks, the rotary table) act as replicated tensors, gradients are brought
to their parameters' placements, and the loss is read with
``full_tensor()``."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import backend
from repro_torch.engine.seeds import step_seed
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import placed


def sharded_ops(params):
    """DTensor's implicit replication where any of ``params`` is a
    DTensor, else nothing."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(p, DTensor) for p in params):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def full_value(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor (a plain tensor as it
    is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def micro_batch(v: torch.Tensor, a: int, i: int) -> torch.Tensor:
    """Rows ``i * B/a .. (i+1) * B/a`` of batch tensor ``v`` (the
    reference's ``reshape(a, B/a, ...)[i]``).  A DTensor whose rows are
    split over data axes is gathered (the blocking all-gather), cut, and
    split over the same axes again where the micro-batch divides (else
    replicated there), so each micro-batch holds the one-rank run's rows."""
    if not hasattr(v, "to_local"):
        return v.reshape(a, v.shape[0] // a, *v.shape[1:])[i]
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.parallel import local as tp

    mesh, pl = v.device_mesh, list(v.placements)
    axes = [d for d, p in enumerate(pl) if p.is_shard(0)
            and mesh.size(d) > 1]
    rows = v.to_local()
    for d in reversed(axes):
        rows = tp.gather(rows, tp.axis_group(mesh, mesh.mesh_dim_names[d]),
                         dim=0)
    mb = v.shape[0] // a
    rows = rows[i * mb:(i + 1) * mb]
    n = 1
    for d in axes:
        n *= mesh.size(d)
    if mb % n == 0:
        idx = 0
        for d in axes:
            idx = idx * mesh.size(d) + tp.axis_rank(mesh,
                                                    mesh.mesh_dim_names[d])
        rows = rows[idx * (mb // n):(idx + 1) * (mb // n)]
    else:
        for d in axes:
            pl[d] = Replicate()
    shape = (mb, *v.shape[1:])
    return DTensor.from_local(rows.contiguous(), mesh, tuple(pl),
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def make_train_step(model, opt: AdamWConfig, accum_dtype=torch.float32,
                    act_impl: str | None = None):
    """``train_step(opt_state, batch) -> {"loss": ...}``: the loss of
    ``batch`` (``tokens`` (B, S), optional ``prefix_embeds`` / the enc-dec's
    ``enc_embeds``) at the
    activation seed ``step_seed(opt_state["step"])``, its gradients, and
    one AdamW update of ``model``'s parameters in place.

    ``cfg.grad_accum = a > 1`` splits the batch into ``a`` micro-batches,
    sums their gradients from zeros in ``accum_dtype`` and divides the sum
    by ``a`` (a tensor: on CUDA a division by a Python number is a
    multiplication by its reciprocal); the loss is the micro-batches' mean.
    No update happens between the micro-batches, so each backward
    recomputes from the parameters its forward saw.  ``act_impl`` pins the
    compression kernels' backend for the step ("torch" | "cuda" | "auto",
    :func:`repro_torch.core.backend.use_impl`); None defers to the config's
    ``act_compression.impl``."""
    cfg = model.cfg
    params = list(model.parameters())

    def loss_fn(mb, step):
        with backend.use_impl(act_impl):
            return model.loss(mb["tokens"],
                              prefix_embeds=mb.get("prefix_embeds"),
                              enc_embeds=mb.get("enc_embeds"),
                              act_seed=step_seed(step),
                              vocab_chunk=cfg.vocab_chunk)

    def train_step(opt_state: dict, batch: dict) -> dict:
        step = opt_state["step"]
        with sharded_ops(params):
            if cfg.grad_accum > 1:
                a = cfg.grad_accum
                grads = [torch.zeros_like(p, dtype=accum_dtype)
                         for p in params]
                losses = []
                for i in range(a):
                    mb = {k: micro_batch(v, a, i)
                          for k, v in batch.items()}
                    loss = loss_fn(mb, step)
                    for s, g, p in zip(grads,
                                       torch.autograd.grad(loss, params),
                                       params):
                        s.add_(placed(g, p).to(accum_dtype))
                    losses.append(full_value(loss.detach()))
                div = torch.tensor(a, dtype=accum_dtype,
                                   device=losses[0].device)
                grads = [g / div for g in grads]
                loss = torch.stack(losses).mean()
            else:
                loss = loss_fn(batch, step)
                grads = torch.autograd.grad(loss, params)
            adamw_update(grads, opt_state, params, opt)
        return {"loss": full_value(loss.detach())}

    return train_step


def make_prefill_step(model, max_seq: int | None = None):
    """``prefill_step(batch) -> (last logits (B, V) float32, cache)``."""

    def prefill_step(batch):
        return model.prefill(batch["tokens"],
                             prefix_embeds=batch.get("prefix_embeds"),
                             enc_embeds=batch.get("enc_embeds"),
                             max_seq=max_seq)

    return prefill_step


def make_serve_step(model):
    """One decode step: greedy next token + updated cache (in place): the
    KV cache of the attention families, the conv and SSD state caches of
    ``ssm`` / ``hybrid`` (and the hybrid's shared-block KV).  A sharded
    model's cache is laid out by ``cache_pspecs``
    (``parallel.sharding.distribute_cache``), and its tokens and logits
    come back as DTensors of each rank's rows."""

    def serve_step(cache, tokens):
        logits, cache = model.decode_step(cache, tokens)
        if hasattr(logits, "to_local"):         # a sharded model: its rows
            from torch.distributed.tensor import DTensor

            local = logits.to_local()
            tok = torch.argmax(local[:, -1], dim=-1).to(torch.int32)[:, None]
            shape = (logits.shape[0], 1)
            return DTensor.from_local(tok, logits.device_mesh,
                                      logits.placements, shape=shape,
                                      stride=(1, 1)), logits, cache
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache

    return serve_step
