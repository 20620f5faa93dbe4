"""The LM (the reference's ``repro.models.transformer``): the dense family
(``dense``, and ``vlm`` without its frontend) and the MoE family
(:mod:`repro_torch.models.moe`'s experts in place of the dense MLP, with
arctic's dense FFN residual under ``ln3`` where the config has one).

Parameters are an ``nn.Module`` tree with the reference's names and
layouts (``wq`` is (d_model, H*Dh) and multiplies from the right), one
module per layer in ``layers`` instead of the reference's stacked layer
axis, and a Python loop over the layers instead of its ``lax.scan``.

Training (``hidden_states`` / ``loss``) wraps each layer by ``act_mode``,
the paper's technique applied to the residual stream:

* ``"none"``: autograd saves everything;
* ``"remat"``: ``torch.utils.checkpoint`` (non-reentrant) a layer;
* ``"act"``: :func:`repro_torch.core.act_compress.compressed_block`: the
  layer input stored block-quantized (INT2, G = 256 by default) and the
  layer recomputed from the reconstruction in the backward.

An MoE layer returns its balance loss beside the residual stream, and the
reference wraps it apart from the others: ``"remat"`` checkpoints the
whole layer, and ``"act"`` stashes nothing compressed (the layer runs as
under ``"none"``), as in the reference.

Training attention is the reference's chunked scan in differentiable ops
(:func:`repro_torch.models.attention.chunked_attention`); ``prefill`` and
``decode_step`` run under ``no_grad`` through the flash kernel and the
cache, as serving does.

Not ported yet, each raising with its ROADMAP item: the SSM, hybrid and
enc-dec families and the vlm frontend (A.11).
"""
from __future__ import annotations

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
from repro_torch.models.layers import (dense_init, embed_init, mm, rmsnorm,
                                       swiglu)
from repro_torch.models.moe import moe_ffn

#: Families this port's Model runs.
FAMILIES = ("dense", "vlm", "moe")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP A.11)")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise _not_ported(f"the {cfg.family!r} family")
    if cfg.frontend is not None and cfg.family != "vlm":
        raise _not_ported(f"the {cfg.frontend!r} frontend")


# ============================================================ param init
def _attn_params(cfg, gen: torch.Generator, d_in=None) -> dict:
    d = d_in or cfg.d_model
    dev = gen.device
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
    dev = gen.device
    return {"ln1": torch.ones(cfg.d_model, device=dev),
            "attn": _attn_params(cfg, gen),
            "ln2": torch.ones(cfg.d_model, device=dev),
            "mlp": _mlp_params(cfg.d_model, cfg.d_ff, gen)}


def _experts(n: int, d_in: int, d_out: int, gen: torch.Generator):
    """(n, d_in, d_out) bf16 at N(0, 1/d_in), drawn an expert at a time so
    the float32 draw is one expert's, not the stack's (arctic's would be
    17.8 GB)."""
    out = torch.empty((n, d_in, d_out), dtype=torch.bfloat16,
                      device=gen.device)
    for i in range(n):
        out[i] = dense_init(d_in, d_out, gen)
    return out


def _moe_layer_params(cfg, gen: torch.Generator) -> dict:
    dev = gen.device
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


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random weights drawn from ``gen`` (on its device), with the
    reference's shapes, dtypes and scales: the embedding in ``act_dtype``,
    dense and expert weights bf16, the router, norms and biases float32."""
    check_family(cfg)
    act_dtype = getattr(torch, getattr(cfg, "act_dtype", "bfloat16"))
    layer = _moe_layer_params if cfg.family == "moe" else _dense_layer_params
    return {"embed": embed_init(cfg.vocab, cfg.d_model, gen, dtype=act_dtype),
            "final_norm": torch.ones(cfg.d_model, device=gen.device),
            "lm_head": dense_init(cfg.d_model, cfg.vocab, gen),
            "layers": [layer(cfg, gen) for _ in range(max(cfg.n_layers, 1))]}


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
    """A decoder-only LM, dense or MoE: ``prefill`` a prompt into a KV
    cache, then ``decode_step`` one token at a time.

    ``params`` is the reference's parameter tree with one dict per layer in
    ``layers`` (see :func:`repro_torch.models.convert.params_from_jax`);
    without it the weights are drawn from ``generator`` (default: seed 0 on
    ``device``).  The model lives on ``device``: the card unless the caller
    asks for the CPU, and a CUDA device without a card raises.  ``impl``
    routes prefill attention (:func:`repro_torch.kernels.ops.flash_attention`):
    ``"auto"`` is the kernel for CUDA tensors and the plain version for CPU
    tensors.
    """

    def __init__(self, cfg, params: dict | None = None, *,
                 device="cuda", generator: torch.Generator | None = None,
                 impl: str = "auto"):
        super().__init__()
        check_family(cfg)
        device = resolve_device(device)
        self.cfg, self.impl = cfg, impl
        if params is None:
            params = init_params(cfg, generator
                                 or torch.Generator(device).manual_seed(0))
        self.embed = nn.Parameter(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.lm_head = nn.Parameter(params["lm_head"])
        self.layers = nn.ModuleList(_module(lp) for lp in params["layers"])
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ---------------------------------------------------- layer wrapping
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

    def _attend(self, h, lp):
        cfg = self.cfg
        return h + attn.attention_block(rmsnorm(h, lp.ln1), lp.attn, cfg,
                                        causal=True, k_chunk=cfg.k_chunk)

    def _dense_layer(self, h, lp):
        return self._ffn(self._attend(h, lp), lp)[0]

    def _moe_layer(self, h, lp):
        return self._ffn(self._attend(h, lp), lp)

    # ------------------------------------------------------------ training
    def hidden_states(self, tokens: torch.Tensor, *, prefix_embeds=None,
                      act_seed: int = 0):
        """Token ids (B, S) (after an optional (B, P, D) prefix) -> (final
        hidden (B, P+S, D), aux loss).  Layer ``li`` stashes with the seed
        ``act_seed + li`` mod 2**32 (the reference's uint32 add)."""
        h = self.embed[tokens]
        if prefix_embeds is not None:
            h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if self.cfg.family == "moe":
            # the reference's MoE branch: remat checkpoints the layer,
            # and no mode stashes it compressed
            layer = self._moe_layer
            if self.cfg.act_mode == "remat":
                layer = functools.partial(checkpoint, self._moe_layer,
                                          use_reentrant=False)
            for lp in self.layers:
                h, a = layer(h, lp)
                aux = aux + a
        else:
            step = self._wrap(self._dense_layer)
            for li, lp in enumerate(self.layers):
                h = step(h, lp, (int(act_seed) + li) & MASK32)
        return rmsnorm(h, self.final_norm), aux

    def loss(self, tokens: torch.Tensor, *, prefix_embeds=None,
             act_seed: int = 0, vocab_chunk: int = 4096):
        """Next-token cross-entropy, the vocabulary projection chunked over
        the sequence so the (B, S, V) float32 logits never exist at once:
        each chunk of ``vocab_chunk`` positions is checkpointed (its logits
        recomputed in the backward), the sequence padded to whole chunks
        with padded positions weighing 0, and the sum divided by the valid
        count times B, as the reference does."""
        cfg = self.cfg
        h, aux = self.hidden_states(tokens, prefix_embeds=prefix_embeds,
                                    act_seed=act_seed)
        npfx = 0 if prefix_embeds is None else prefix_embeds.shape[1]
        h_pred = h[:, npfx:npfx + tokens.shape[1] - 1]
        targets = tokens[:, 1:].to(torch.int64)
        b, s = h_pred.shape[0], h_pred.shape[1]
        n_chunks = max(1, -(-s // vocab_chunk))
        pad = n_chunks * vocab_chunk - s
        if pad:
            h_pred = F.pad(h_pred, (0, 0, 0, pad))
            targets = F.pad(targets, (0, pad))
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
        logits = mm(hx, self.lm_head).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tx[..., None])[..., 0]
        return torch.sum((lse - gold) * vx.to(torch.float32))

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
        y, aux = moe_ffn(rmsnorm(h, lp.ln2), lp.moe, n_experts=cfg.n_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.moe_capacity_factor)
        return h + y, aux

    def _logits(self, h):
        return mm(rmsnorm(h, self.final_norm), self.lm_head).to(torch.float32)

    # ------------------------------------------------------------ decode
    def init_cache(self, batch: int, max_seq: int,
                   dtype=torch.bfloat16) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        return {"pos": torch.zeros(batch, dtype=torch.int32,
                                   device=self.device),
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, prefix_embeds=None,
                max_seq: int | None = None):
        """Process a prompt, returning (last_logits (B,V) float32, cache).
        ``max_seq`` sizes the cache (>= prompt length); the cache's k/v are
        (L, B, max_seq, Hkv, Dh), zero past the prompt."""
        cfg = self.cfg
        h = self.embed[tokens]
        if prefix_embeds is not None:
            h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
        b, s, _ = h.shape
        positions = torch.arange(s, device=h.device).expand(b, s)
        n_rep = cfg.n_heads // cfg.n_kv_heads
        # written layer by layer: stacking a list would hold every layer's
        # K and V twice at the end
        cache = self.init_cache(b, max_seq or s, dtype=h.dtype)
        cache["pos"].fill_(s)
        for li, lp in enumerate(self.layers):
            x = rmsnorm(h, lp.ln1)
            q, k, v = attn.qkv_project(x, lp.attn, cfg, positions)
            out = attn.online_attention(
                q, attn._repeat_kv(k, n_rep), attn._repeat_kv(v, n_rep),
                causal=True, impl=self.impl)
            h = h + mm(out.reshape(b, s, cfg.n_heads * cfg.d_head),
                       lp.attn.wo)
            h, _ = self._ffn(h, lp)
            cache["k"][li, :, :s] = k
            cache["v"][li, :, :s] = v
        return self._logits(h[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B, 1) -> (logits (B, 1, V) float32, cache).  The cache's
        k/v are updated in place."""
        h = self.embed[tokens]
        pos = cache["pos"]
        for li, lp in enumerate(self.layers):
            a, _, _ = attn.attention_decode(rmsnorm(h, lp.ln1), lp.attn,
                                            self.cfg, cache["k"][li],
                                            cache["v"][li], pos)
            h, _ = self._ffn(h + a, lp)
        cache["pos"] = pos + 1
        return self._logits(h), cache
