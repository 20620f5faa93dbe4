"""The LM (the reference's ``repro.models.transformer``): every family of
the reference.

* ``dense`` (and ``vlm``, whose vision frontend is a stub: the caller
  hands over ``prefix_embeds``);
* ``moe``: :mod:`repro_torch.models.moe`'s experts in place of the dense
  MLP, with arctic's dense FFN residual under ``ln3`` where the config has
  one;
* ``ssm``: Mamba-2 layers (:mod:`repro_torch.models.ssm`), attention-free;
* ``hybrid``: Mamba-2 layers with one shared attention + MLP block at
  twice the width, fed ``[h, h0]`` (h0 the embeddings) at
  ``cfg.shared_attn_sites()``;
* ``encdec``: a non-causal encoder over ``enc_embeds`` (the audio
  frontend's stub output) and a decoder whose layers cross-attend to it.

Parameters are an ``nn.Module`` tree with the reference's names and
layouts (``wq`` is (d_model, H*Dh) and multiplies from the right), one
module per layer in ``layers`` (and ``enc_layers``) instead of the
reference's stacked layer axis, and a Python loop over the layers instead
of its ``lax.scan``.

Training (``hidden_states`` / ``loss``) wraps each layer by ``act_mode``,
the paper's technique applied to the residual stream:

* ``"none"``: autograd saves everything;
* ``"remat"``: ``torch.utils.checkpoint`` (non-reentrant) a layer;
* ``"act"``: :func:`repro_torch.core.act_compress.compressed_block`: the
  layer input stored block-quantized (INT2, G = 256 by default) and the
  layer recomputed from the reconstruction in the backward.

Dense and Mamba-2 layers are wrapped so, with the global layer index as
the stash seed; the hybrid's shared block is never wrapped.  Two families
wrap apart, as the reference does: an MoE layer returns its balance loss
beside the residual stream, so ``"remat"`` checkpoints the whole layer and
``"act"`` stashes nothing compressed (the layer runs as under ``"none"``);
the enc-dec checkpoints every encoder and decoder layer under both
``"remat"`` and ``"act"``, so ``"act"`` stashes nothing compressed there
either.

Training attention is the reference's chunked scan in differentiable ops
(:func:`repro_torch.models.attention.chunked_attention`); ``prefill`` and
``decode_step`` run under ``no_grad`` through the flash kernel and the
cache, as serving does: every attention of a prefill (the encoder's
non-causal one and the hybrid's shared block included) and the decoder's
cross-attention at every decode step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.act_compress import compressed_block
from repro_torch.core.compressor import CompressionConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.prng import MASK32
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, mm, normal,
                                       rmsnorm, swiglu)
from repro_torch.models import ssm as ssmmod
from repro_torch.models.moe import moe_ffn
from repro_torch.parallel.annotate import shard
from repro_torch.parallel import local as tp
from repro_torch.parallel.local import row_parallel

#: The families Model runs (all of the reference's).
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
#: The stub frontend each family takes: the caller hands over its output
#: (``prefix_embeds`` / ``enc_embeds``).
FRONTENDS = {"vlm": "vision", "encdec": "audio"}


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; have {FAMILIES}")
    if cfg.frontend is not None and FRONTENDS.get(cfg.family) \
            != cfg.frontend:
        raise ValueError(f"the {cfg.frontend!r} frontend belongs to no "
                         f"{cfg.family!r} model")


def shared_cfg(cfg):
    """The hybrid's shared block: attention at twice the width, d_head
    ``2 * d_model / n_heads``."""
    return dataclasses.replace(cfg, d_model=2 * cfg.d_model,
                               d_head=2 * cfg.d_model // cfg.n_heads)


# ============================================================ param init
def _dev(gen) -> torch.device:
    """The device of a generator, or the device itself (shapes alone)."""
    return gen if isinstance(gen, torch.device) else gen.device


def _attn_params(cfg, gen: torch.Generator, d_in=None) -> dict:
    d = d_in or cfg.d_model
    dev = _dev(gen)
    p = {
        "wq": dense_init(d, cfg.n_heads * cfg.d_head, gen),
        "wk": dense_init(d, cfg.n_kv_heads * cfg.d_head, gen),
        "wv": dense_init(d, cfg.n_kv_heads * cfg.d_head, gen),
        "wo": dense_init(cfg.n_heads * cfg.d_head, d, gen),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.n_heads * cfg.d_head, device=dev)
        p["bk"] = torch.zeros(cfg.n_kv_heads * cfg.d_head, device=dev)
        p["bv"] = torch.zeros(cfg.n_kv_heads * cfg.d_head, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(cfg.d_head, device=dev)
        p["k_norm"] = torch.ones(cfg.d_head, device=dev)
    return p


def _mlp_params(d_model: int, d_ff: int, gen: torch.Generator) -> dict:
    return {"w_gate": dense_init(d_model, d_ff, gen),
            "w_up": dense_init(d_model, d_ff, gen),
            "w_down": dense_init(d_ff, d_model, gen)}


def _dense_layer_params(cfg, gen: torch.Generator) -> dict:
    dev = _dev(gen)
    return {"ln1": torch.ones(cfg.d_model, device=dev),
            "attn": _attn_params(cfg, gen),
            "ln2": torch.ones(cfg.d_model, device=dev),
            "mlp": _mlp_params(cfg.d_model, cfg.d_ff, gen)}


def _experts(n: int, d_in: int, d_out: int, gen: torch.Generator):
    """(n, d_in, d_out) bf16 at N(0, 1/d_in), drawn an expert at a time so
    the float32 draw is one expert's, not the stack's (arctic's would be
    17.8 GB)."""
    out = torch.empty((n, d_in, d_out), dtype=torch.bfloat16,
                      device=_dev(gen))
    if isinstance(gen, torch.device):
        return out                       # shapes alone
    for i in range(n):
        out[i] = dense_init(d_in, d_out, gen)
    return out


def _moe_layer_params(cfg, gen: torch.Generator) -> dict:
    dev = _dev(gen)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {"ln1": torch.ones(d, device=dev),
         "attn": _attn_params(cfg, gen),
         "ln2": torch.ones(d, device=dev),
         "moe": {"router": dense_init(d, e, gen, dtype=torch.float32),
                 "w_gate": _experts(e, d, f, gen),
                 "w_up": _experts(e, d, f, gen),
                 "w_down": _experts(e, f, d, gen)}}
    if cfg.dense_residual:
        p["ln3"] = torch.ones(d, device=dev)
        p["mlp"] = _mlp_params(d, cfg.d_ff, gen)
    return p


def _ssm_layer_params(cfg, gen: torch.Generator) -> dict:
    """A Mamba-2 layer: its norm and the mixer's unfused projections, the
    convs N(0, 1) * 0.2 in bf16, ``a_log`` 0, ``d_skip`` 1, ``dt_bias``
    and the conv biases 0."""
    dev = _dev(gen)
    d_inner, n_heads = ssmmod.ssm_dims(cfg)
    d, n = cfg.d_model, cfg.ssm_state

    def conv(c):
        return (normal((cfg.ssm_conv, c), gen) * 0.2).to(torch.bfloat16)

    zeros = functools.partial(torch.zeros, device=dev)
    return {"ln": torch.ones(d, device=dev),
            "mixer": {"w_z": dense_init(d, d_inner, gen),
                      "w_x": dense_init(d, d_inner, gen),
                      "w_B": dense_init(d, n, gen),
                      "w_C": dense_init(d, n, gen),
                      "w_dt": dense_init(d, n_heads, gen),
                      "conv_x": conv(d_inner), "conv_B": conv(n),
                      "conv_C": conv(n),
                      "conv_bx": zeros(d_inner), "conv_bB": zeros(n),
                      "conv_bC": zeros(n), "dt_bias": zeros(n_heads),
                      "a_log": zeros(n_heads),
                      "d_skip": torch.ones(n_heads, device=dev),
                      "norm_w": torch.ones(d_inner, device=dev),
                      "out_proj": dense_init(d_inner, d, gen)}}


def _shared_attn_params(cfg, gen: torch.Generator) -> dict:
    """The hybrid's shared block at width 2 * d_model, and its ``down``
    projection back to d_model."""
    dev, d2 = _dev(gen), 2 * cfg.d_model
    return {"ln": torch.ones(d2, device=dev),
            "attn": _attn_params(shared_cfg(cfg), gen),
            "ln2": torch.ones(d2, device=dev),
            "mlp": _mlp_params(d2, cfg.d_ff, gen),
            "down": dense_init(d2, cfg.d_model, gen)}


def _dec_layer_params(cfg, gen: torch.Generator) -> dict:
    """An enc-dec decoder layer: a dense layer with cross-attention under
    ``ln_x``."""
    p = _dense_layer_params(cfg, gen)
    p["ln_x"] = torch.ones(cfg.d_model, device=_dev(gen))
    p["xattn"] = _attn_params(cfg, gen)
    return p


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random weights drawn from ``gen`` (on its device), with the
    reference's shapes, dtypes and scales: the embedding in ``act_dtype``,
    dense, expert and conv weights bf16, the router, norms, biases and
    the SSM's scalars float32.  ``gen`` may instead be a device
    (``torch.device("meta")``): the tree's shapes and dtypes there, no
    draw made (:func:`repro_torch.parallel.sharding.param_pspecs` walks
    it)."""
    check_family(cfg)
    act_dtype = getattr(torch, getattr(cfg, "act_dtype", "bfloat16"))
    layer = {"moe": _moe_layer_params, "ssm": _ssm_layer_params,
             "hybrid": _ssm_layer_params,
             "encdec": _dec_layer_params}.get(cfg.family,
                                              _dense_layer_params)
    params = {"embed": embed_init(cfg.vocab, cfg.d_model, gen,
                                  dtype=act_dtype),
              "final_norm": torch.ones(cfg.d_model, device=_dev(gen)),
              "lm_head": dense_init(cfg.d_model, cfg.vocab, gen),
              "layers": [layer(cfg, gen)
                         for _ in range(max(cfg.n_layers, 1))]}
    if cfg.family == "hybrid":
        params["shared_attn"] = _shared_attn_params(cfg, gen)
    elif cfg.family == "encdec":
        params["enc_layers"] = [_dense_layer_params(cfg, gen)
                                for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = torch.ones(cfg.d_model, device=_dev(gen))
    return params


def cache_shapes(cfg, batch: int, max_seq: int, enc_len: int = 0,
                 dtype=torch.bfloat16) -> dict:
    """:func:`init_cache`'s entries as shapes alone, ``{name: (shape,
    dtype)}`` (no tensor: a traced step charges every tensor it makes)."""
    out = {"pos": ((batch,), torch.int32)}

    def kv(n, d_head):
        return (n, batch, max_seq, cfg.n_kv_heads, d_head), dtype

    if cfg.family in ("ssm", "hybrid"):
        d_inner, n_heads = ssmmod.ssm_dims(cfg)
        out["conv"] = ((cfg.n_layers, batch, cfg.ssm_conv - 1,
                        d_inner + 2 * cfg.ssm_state), dtype)
        out["ssd"] = ((cfg.n_layers, batch, n_heads, cfg.ssm_headdim,
                       cfg.ssm_state), torch.float32)
        if cfg.family == "hybrid":
            ns = len(cfg.shared_attn_sites())
            out["shared_k"] = out["shared_v"] = kv(ns, shared_cfg(cfg).d_head)
    else:
        out["k"] = out["v"] = kv(cfg.n_layers, cfg.d_head)
        if cfg.family == "encdec":
            out["enc"] = ((batch, enc_len, cfg.d_model), dtype)
    return out


def init_cache(cfg, batch: int, max_seq: int, enc_len: int = 0,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """Zeros of the family's cache on ``device`` (``meta`` for shapes
    alone): k/v (L, B, max_seq, Hkv, Dh) for the attention families (and
    the encoder's output ``enc`` (B, enc_len, D) for ``encdec``); for
    ``ssm`` / ``hybrid`` the conv cache (L, B, K-1, d_inner + 2N) and the
    float32 SSD state (L, B, H, P, N), and the hybrid's shared-block k/v,
    one per site."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_shapes(cfg, batch, max_seq,
                                                  enc_len, dtype).items()}


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``x`` (B, S, ...) with ``pad`` zero positions appended along S.  A
    DTensor (sharded along anything but S) pads shard by shard: the
    padding is local to every shard, and torch 2.11's DTensor gives a
    padded tensor on a two-dim mesh a one-dim layout."""
    widths = (0, 0) * (x.dim() - 2) + (0, pad)
    if not hasattr(x, "to_local"):
        return F.pad(x, widths)
    from torch.distributed.tensor import DTensor

    if any(p.is_shard(1) for p in x.placements):
        raise ValueError(f"padding the sequence of {x.placements}")
    local = F.pad(x.to_local(), widths)
    shape = (x.shape[0], x.shape[1] + pad, *x.shape[2:])
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _vocab_parallel_nll(logits, targets):
    """``logsumexp(logits) - logits[target]`` (B, S) of DTensor logits laid
    out (batch, None, vocab), without gathering them: each rank takes the
    logsumexp and the gold logit of its own vocabulary shard, and
    all-reduces of (B, S) values combine them: the largest shard's
    logsumexp (a max, outside the graph: it cancels), the shards'
    ``exp(lse - max)`` (a sum), and the gold logit, which one shard holds
    (a sum).  DTensor's own ops would gather the chunk's logits (its
    logsumexp does; its gather leaves a masked partial it cannot
    reduce)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, pl = logits.device_mesh, tuple(logits.placements)
    if any(p.is_partial() or p.is_shard(1) for p in pl):
        raise ValueError(f"vocab-parallel loss of logits laid out {pl}")
    b, s, v = logits.shape
    _, offset = compute_local_shape_and_global_offset((b, s, v), mesh, pl)
    local = logits.to_local()
    tx = targets.to_local() if hasattr(targets, "to_local") else targets
    if tx.shape != local.shape[:2]:
        raise ValueError(f"targets' shard {tuple(tx.shape)} is not the "
                         f"logits' rows {tuple(local.shape[:2])}")
    idx = tx - offset[2]
    inside = (idx >= 0) & (idx < local.shape[2])
    gold = torch.where(inside, torch.gather(
        local, -1, idx.clamp(0, local.shape[2] - 1)[..., None])[..., 0], 0.0)
    rows = tuple(Replicate() if p.is_shard(2) else p for p in pl)

    def reduce(t, op="sum"):
        return DTensor.from_local(
            t, mesh, tuple(Partial(op) if p.is_shard(2) else p for p in pl),
            shape=(b, s), stride=(s, 1)).redistribute(mesh, rows).to_local()

    part = torch.logsumexp(local, -1)
    top = reduce(part.detach(), "max")
    lse = top + torch.log(reduce(torch.exp(part - top)))
    return DTensor.from_local(lse - reduce(gold), mesh, rows, shape=(b, s),
                              stride=(s, 1))


def _module(tree: dict) -> nn.Module:
    """A nested dict of tensors as an ``nn.Module`` of parameters."""
    m = nn.Module()
    for name, val in tree.items():
        if isinstance(val, dict):
            m.add_module(name, _module(val))
        else:
            m.register_parameter(name, nn.Parameter(val))
    return m


class Model(nn.Module):
    """An LM of any of the reference's families: ``hidden_states`` /
    ``loss`` for training, ``prefill`` a prompt into a cache, then
    ``decode_step`` one token at a time.

    ``params`` is the reference's parameter tree with one dict per layer in
    ``layers`` (and ``enc_layers``) (see
    :func:`repro_torch.models.convert.params_from_jax`); without it the
    weights are drawn from ``generator`` (default: seed 0 on ``device``).
    The model lives on ``device``: the card unless the caller asks for the
    CPU, and a CUDA device without a card raises.  ``impl`` routes the
    attention of prefill and of decode's cross-attention
    (:func:`repro_torch.kernels.ops.flash_attention`): ``"auto"`` is the
    kernel for CUDA tensors and the plain version for CPU tensors.
    """

    def __init__(self, cfg, params: dict | None = None, *,
                 device="cuda", generator: torch.Generator | None = None,
                 impl: str = "auto"):
        super().__init__()
        check_family(cfg)
        device = resolve_device(device)
        self.cfg, self.impl = cfg, impl
        self.shared_cfg = shared_cfg(cfg) if cfg.family == "hybrid" else None
        if params is None:
            params = init_params(cfg, generator
                                 or torch.Generator(device).manual_seed(0))
        self.embed = nn.Parameter(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = nn.Parameter(params["lm_head"])
        self.layers = nn.ModuleList(_module(lp) for lp in params["layers"])
        if cfg.family == "hybrid":
            self.shared_attn = _module(params["shared_attn"])
        elif cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(_module(lp)
                                            for lp in params["enc_layers"])
            self.enc_norm = nn.Parameter(params["enc_norm"])
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---------------------------------------------------- layer wrapping
    def _embed(self, tokens, prefix_embeds=None):
        """The token embeddings (B, S, D), after an optional (B, P, D)
        prefix."""
        # a sharded table is looked up, not indexed: DTensor runs the
        # lookup vocab-parallel (one all-reduce of the rows) where indexing
        # would gather the table; a plain one keeps the index, whose
        # backward sums a token's rows in its own order
        h = (F.embedding(tokens, self.embed)
             if hasattr(self.embed, "to_local") else self.embed[tokens])
        if prefix_embeds is not None:
            # the vocab-parallel lookup's rows are a masked partial sum,
            # which DTensor cannot concatenate: reduce them first
            h = torch.cat([prefix_embeds.to(h.dtype),
                           shard(h, "batch", None, None)], dim=1)
        return h

    def _wrap(self, layer_fn):
        """``act_mode`` around ``layer_fn(x, lp) -> x``, as
        ``step(x, lp, seed)``."""
        cfg = self.cfg
        if cfg.act_mode == "act":
            comp = cfg.act_compression or CompressionConfig(
                bits=2, group_size=256, rp_ratio=0)
            offload = getattr(cfg, "act_offload", None)
            return compressed_block(
                layer_fn, comp,
                offload=None if offload == "device" else offload)
        if cfg.act_mode == "remat":
            return lambda x, lp, seed: checkpoint(layer_fn, x, lp,
                                                  use_reentrant=False)
        return lambda x, lp, seed: layer_fn(x, lp)

    def _attend(self, h, lp, causal: bool = True):
        cfg = self.cfg
        return h + attn.attention_block(rmsnorm(h, lp.ln1), lp.attn, cfg,
                                        causal=causal, k_chunk=cfg.k_chunk)

    def _dense_layer(self, h, lp):
        h = shard(h, "batch", None, None)
        # the output projection sums partial products over `model`: reduce
        # them before the norm (as the reference's GSPMD does), or DTensor
        # would gather the MLP's weights to multiply a partial sum
        h = shard(self._attend(h, lp), "batch", None, None)
        return shard(self._ffn(h, lp)[0], "batch", None, None)

    def _moe_layer(self, h, lp):
        h = shard(h, "batch", None, None)
        h, aux = self._ffn(shard(self._attend(h, lp), "batch", None, None),
                           lp)
        return shard(h, "batch", None, None), aux

    def _enc_layer(self, h, lp):
        h = shard(h, "batch", None, None)
        h = shard(self._attend(h, lp, causal=False), "batch", None, None)
        return shard(self._ffn(h, lp)[0], "batch", None, None)

    def _dec_layer(self, h, lp, enc):
        h = shard(h, "batch", None, None)
        h = shard(self._attend(h, lp), "batch", None, None)
        h = shard(h + attn.cross_attention_block(rmsnorm(h, lp.ln_x),
                                                 lp.xattn, self.cfg, enc),
                  "batch", None, None)
        return shard(self._ffn(h, lp)[0], "batch", None, None)

    def _ssm_layer(self, h, lp):
        cfg = self.cfg
        return h + ssmmod.mamba2_block(rmsnorm(h, lp.ln), lp.mixer, cfg,
                                       chunk=cfg.ssm_chunk)

    def _shared_block(self, h, h0):
        """The hybrid's shared attention + MLP on ``[h, h0]``, projected
        back down and added to h."""
        sp = self.shared_attn
        x = torch.cat([h, h0], dim=-1)
        x = shard(x + attn.attention_block(rmsnorm(x, sp.ln), sp.attn,
                                           self.shared_cfg, causal=True,
                                           k_chunk=self.cfg.k_chunk),
                  "batch", None, None)
        x = shard(self._ffn(x, sp)[0], "batch", None, None)
        return h + shard(row_parallel(x, sp.down), "batch", None, None)

    # ------------------------------------------------------------ training
    def hidden_states(self, tokens: torch.Tensor, *, prefix_embeds=None,
                      enc_embeds=None, act_seed: int = 0):
        """Token ids (B, S) (after an optional (B, P, D) prefix) -> (final
        hidden (B, P+S, D), aux loss).  Layer ``li`` stashes with the seed
        ``act_seed + li`` mod 2**32 (the reference's uint32 add).  For
        ``encdec``, ``enc_embeds`` (B, Se, D) is the audio frontend's stub
        output and the tokens are the decoder's."""
        cfg = self.cfg
        # the residual stream as the first layer takes it (a stashed layer
        # stores its input as it arrives)
        h = shard(self._embed(tokens, prefix_embeds), "batch", None, None)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.family == "moe":
            # the reference's MoE branch: remat checkpoints the layer,
            # and no mode stashes it compressed
            layer = self._moe_layer
            if cfg.act_mode == "remat":
                layer = functools.partial(checkpoint, self._moe_layer,
                                          use_reentrant=False)
            for lp in self.layers:
                h, a = layer(h, lp)
                aux = aux + a
        elif cfg.family == "encdec":
            # the reference's enc-dec branch: remat and act checkpoint
            # every layer, and no mode stashes one compressed
            enc_layer, dec_layer = self._enc_layer, self._dec_layer
            if cfg.act_mode in ("remat", "act"):
                enc_layer = functools.partial(checkpoint, enc_layer,
                                              use_reentrant=False)
                dec_layer = functools.partial(checkpoint, dec_layer,
                                              use_reentrant=False)
            enc = enc_embeds.to(h.dtype)
            for lp in self.enc_layers:
                enc = enc_layer(enc, lp)
            enc = rmsnorm(enc, self.enc_norm)
            for lp in self.layers:
                h = dec_layer(h, lp, enc)
        else:
            ssm = cfg.family in ("ssm", "hybrid")
            step = self._wrap(self._ssm_layer if ssm else self._dense_layer)
            sites, h0 = cfg.shared_attn_sites(), h
            for li, lp in enumerate(self.layers):
                if li in sites:
                    h = self._shared_block(h, h0)
                h = step(h, lp, (int(act_seed) + li) & MASK32)
        return rmsnorm(h, self.final_norm), aux

    def loss(self, tokens: torch.Tensor, *, prefix_embeds=None,
             enc_embeds=None, act_seed: int = 0, vocab_chunk: int = 4096):
        """Next-token cross-entropy, the vocabulary projection chunked over
        the sequence so the (B, S, V) float32 logits never exist at once:
        each chunk of ``vocab_chunk`` positions is checkpointed (its logits
        recomputed in the backward), the sequence padded to whole chunks
        with padded positions weighing 0, and the sum divided by the valid
        count times B, as the reference does."""
        cfg = self.cfg
        h, aux = self.hidden_states(tokens, prefix_embeds=prefix_embeds,
                                    enc_embeds=enc_embeds,
                                    act_seed=act_seed)
        npfx = 0 if prefix_embeds is None else prefix_embeds.shape[1]
        h_pred = h[:, npfx:npfx + tokens.shape[1] - 1]
        targets = tokens[:, 1:].to(torch.int64)
        b, s = h_pred.shape[0], h_pred.shape[1]
        n_chunks = max(1, -(-s // vocab_chunk))
        pad = n_chunks * vocab_chunk - s
        if pad:
            h_pred = _pad_seq(h_pred, pad)
            targets = _pad_seq(targets, pad)
        valid = (torch.arange(n_chunks * vocab_chunk, device=h.device)
                 < s).reshape(n_chunks, vocab_chunk)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(n_chunks):
            sl = slice(c * vocab_chunk, (c + 1) * vocab_chunk)
            total = total + checkpoint(self._chunk_nll, h_pred[:, sl],
                                       targets[:, sl], valid[c],
                                       use_reentrant=False)
        nll = total / torch.clamp(valid.sum() * b, min=1)
        return nll + cfg.aux_loss_weight * aux

    def _chunk_nll(self, hx, tx, vx):
        logits = shard(mm(hx, self.lm_head).to(torch.float32), "batch", None,
                       "vocab")
        if hasattr(logits, "to_local"):
            nll = _vocab_parallel_nll(logits, tx)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            nll = lse - torch.gather(logits, -1, tx[..., None])[..., 0]
        return torch.sum(nll * vx.to(torch.float32))

    def _ffn(self, h, lp):
        """The layer's FFN on the residual stream -> (h, aux), shared by
        training, prefill, decode and the serving engine: the dense SwiGLU
        under ``ln2`` (aux None); for MoE the dense residual under ``ln3``
        first where the config has one, then the experts under ``ln2``,
        aux their balance loss."""
        cfg = self.cfg
        moe = cfg.family == "moe"
        if not moe or cfg.dense_residual:
            m = lp.mlp
            h = h + swiglu(rmsnorm(h, lp.ln3 if moe else lp.ln2), m.w_gate,
                           m.w_up, m.w_down)
        if not moe:
            return h, None
        h = shard(h, "batch", None, None)
        y, aux = moe_ffn(rmsnorm(h, lp.ln2), lp.moe, n_experts=cfg.n_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.moe_capacity_factor)
        return h + y, aux

    def _logits(self, h):
        return mm(rmsnorm(h, self.final_norm), self.lm_head).to(torch.float32)

    # ------------------------------------------------------------ decode
    def init_cache(self, batch: int, max_seq: int, enc_len: int = 0,
                   dtype=torch.bfloat16) -> dict:
        """:func:`init_cache` on the model's device; for a sharded model
        laid out by ``cache_pspecs`` (each rank allocating its own shard,
        :func:`repro_torch.parallel.sharding.zeros_cache`)."""
        mesh = getattr(self.embed, "device_mesh", None)
        if mesh is None:
            return init_cache(self.cfg, batch, max_seq, enc_len, dtype,
                              self.device)
        from repro_torch.parallel.sharding import zeros_cache

        return zeros_cache(self.cfg, cache_shapes(self.cfg, batch, max_seq,
                                                  enc_len, dtype),
                           mesh, batch, max_seq, self.device)

    def _prefill_attn(self, x, p, acfg, causal: bool):
        """A prompt's attention: (output after ``wo``, k, v).  Through
        :func:`attn.online_attention` (the kernel on the card); a sharded
        model's DTensors through :func:`attn.chunked_attention`, shard by
        shard (the reference's ``k_chunk`` scan: the kernel has no DTensor
        face)."""
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = attn.qkv_project(x, p, acfg, positions)
        n_rep = acfg.n_heads // acfg.n_kv_heads
        kr, vr = attn._repeat_kv(k, n_rep), attn._repeat_kv(v, n_rep)
        if hasattr(q, "to_local"):
            out = attn.chunked_attention(q, kr, vr, causal=causal,
                                         k_chunk=self.cfg.k_chunk)
        else:
            out = attn.online_attention(q, kr, vr, causal=causal,
                                        impl=self.impl)
        out = shard(out.reshape(b, s, acfg.n_heads * acfg.d_head), "batch",
                    None, "attn_out")
        return shard(mm(out, p.wo), "batch", None, None), k, v

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, prefix_embeds=None,
                enc_embeds=None, max_seq: int | None = None):
        """Process a prompt, returning (last_logits (B,V) float32, cache).
        ``max_seq`` sizes the cache's k/v (>= prompt length); they are
        zero past the prompt.

        ``ssm`` / ``hybrid``: the conv cache holds each layer's last K-1
        raw projections (before the conv), the SSD state the scan's final
        one, and the hybrid's shared block its own dense K/V at each site
        (``h0`` the whole embedding sequence).

        ``encdec``, as the reference: the encoder runs over
        ``enc_embeds`` into ``cache["enc"]``, decoding starts at position
        0, and the logits come from the *embedding* of the prompt's last
        token: the decoder never reads the prompt.

        A sharded model (DTensor parameters and inputs laid out by
        ``batch_pspecs``) runs the training path's sharded layers, with
        DTensor's implicit replication on (the plain positions act as
        replicated tensors), and its cache is laid out by
        ``cache_pspecs``."""
        sharded = hasattr(self.embed, "device_mesh")
        if sharded:
            from torch.distributed.tensor.experimental import \
                implicit_replication
        with implicit_replication() if sharded else contextlib.nullcontext():
            return self._prefill(tokens, prefix_embeds, enc_embeds, max_seq)

    def _prefill(self, tokens, prefix_embeds, enc_embeds, max_seq):
        cfg = self.cfg
        h = shard(self._embed(tokens, prefix_embeds), "batch", None, None)
        b, s, _ = h.shape
        # written layer by layer: stacking a list would hold every layer's
        # cache twice at the end
        cache = self.init_cache(b, max_seq or s, dtype=h.dtype)
        if cfg.family == "encdec":
            enc = shard(enc_embeds.to(h.dtype), "batch", None, None)
            for lp in self.enc_layers:
                a, _, _ = self._prefill_attn(rmsnorm(enc, lp.ln1), lp.attn,
                                             cfg, causal=False)
                enc = shard(self._ffn(shard(enc + a, "batch", None, None),
                                      lp)[0], "batch", None, None)
            cache["enc"] = rmsnorm(enc, self.enc_norm)
            return self._logits(h[:, -1]), cache
        cache["pos"].fill_(s)
        if cfg.family in ("ssm", "hybrid"):
            sites, h0, kw = cfg.shared_attn_sites(), h, cfg.ssm_conv - 1
            for li, lp in enumerate(self.layers):
                if li in sites:
                    si, sp = sites.index(li), self.shared_attn
                    x = torch.cat([h, h0], dim=-1)
                    a, k, v = self._prefill_attn(rmsnorm(x, sp.ln), sp.attn,
                                                 self.shared_cfg, causal=True)
                    tp.write(cache["shared_k"], si, k)
                    tp.write(cache["shared_v"], si, v)
                    x = shard(self._ffn(shard(x + a, "batch", None, None),
                                        sp)[0], "batch", None, None)
                    h = h + shard(row_parallel(x, sp.down), "batch", None,
                                  None)
                x = rmsnorm(h, lp.ln)
                y, state = ssmmod.mamba2_block(x, lp.mixer, cfg,
                                               chunk=cfg.ssm_chunk,
                                               return_state=True)
                tp.write(cache["ssd"], li, state)
                tp.write(cache["conv"], li,
                         ssmmod.conv_inputs(x, lp.mixer)[:, s - kw:])
                h = shard(h + y, "batch", None, None)
        else:
            for li, lp in enumerate(self.layers):
                a, k, v = self._prefill_attn(rmsnorm(h, lp.ln1), lp.attn,
                                             cfg, causal=True)
                h = shard(self._ffn(shard(h + a, "batch", None, None), lp)[0],
                          "batch", None, None)
                tp.write(cache["k"], li, k)
                tp.write(cache["v"], li, v)
        return self._logits(h[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V) float32, cache).  The cache
        is updated in place.  The hybrid's shared block reads ``[h, h0]``
        with h0 the current token's embedding; the enc-dec decoder
        cross-attends to ``cache["enc"]`` every step, projecting its K/V
        anew as the reference does.

        A sharded model decodes on each rank's local rows with plain
        tensors (:class:`repro_torch.parallel.local.CacheView`), its cache
        laid out by ``cache_pspecs``: every head of q, k and v whole on
        every rank over the rank's slice of the K/V sequence (combined by
        log-sum-exp), the SSD's own heads, the expert-parallel MoE, the
        vocabulary-parallel lookup; the tokens may be the whole batch or
        the DTensor of rows the last step returned, and the logits come
        back as a DTensor of this rank's rows."""
        cfg = self.cfg
        view = tp.CacheView(self.embed, cache)
        h = tp.lookup(self.embed, view.rows(tokens))
        pos = view.pos
        if cfg.family in ("ssm", "hybrid"):
            conv, ssd = view.local(cache["conv"]), view.local(cache["ssd"])
            sites, h0 = cfg.shared_attn_sites(), h
            for li, lp in enumerate(self.layers):
                if li in sites:
                    si, sp = sites.index(li), self.shared_attn
                    x = torch.cat([h, h0], dim=-1)
                    a, _, _ = attn.attention_decode(
                        rmsnorm(x, sp.ln), sp.attn, self.shared_cfg,
                        view.local(cache["shared_k"])[si],
                        view.local(cache["shared_v"])[si], pos,
                        seq=view.seq(cache["shared_k"]))
                    x, _ = self._ffn(x + a, sp)
                    h = h + mm(x, sp.down)
                y, conv[li], ssd[li] = ssmmod.mamba2_decode(
                    rmsnorm(h, lp.ln), lp.mixer, cfg, conv[li], ssd[li])
                h = h + y
        else:
            ck, cv = view.local(cache["k"]), view.local(cache["v"])
            seq = view.seq(cache["k"])
            for li, lp in enumerate(self.layers):
                a, _, _ = attn.attention_decode(rmsnorm(h, lp.ln1), lp.attn,
                                                cfg, ck[li], cv[li], pos,
                                                seq=seq)
                h = h + a
                if cfg.family == "encdec":
                    h = h + attn.cross_attention_block(
                        rmsnorm(h, lp.ln_x), lp.xattn, cfg,
                        view.local(cache["enc"]), online=True,
                        impl=self.impl)
                h, _ = self._ffn(h, lp)
        cache["pos"] = cache["pos"] + 1
        return view.wrap(self._logits(h)), cache
