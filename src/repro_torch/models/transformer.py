"""The LM (the reference's ``repro.models.transformer``), dense family:
``dense``, and ``vlm`` without its frontend.

Parameters are an ``nn.Module`` tree with the reference's names and
layouts (``wq`` is (d_model, H*Dh) and multiplies from the right), one
module per layer in ``layers`` instead of the reference's stacked layer
axis.  Weights are frozen (``requires_grad=False``): this slice serves.

Not ported yet, each raising with its ROADMAP item: the MoE, SSM, hybrid
and enc-dec families and the vlm frontend (A.11), and the training path
(``hidden_states``/``loss`` with ``act_mode`` wrapping, A.11).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, mm, rmsnorm,
                                       swiglu)

#: Families this port's Model runs.
FAMILIES = ("dense", "vlm")


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


def init_params(cfg, gen: torch.Generator) -> dict:
    """Random weights drawn from ``gen`` (on its device), with the
    reference's shapes, dtypes and scales: the embedding in ``act_dtype``,
    dense weights bf16, norms and biases float32."""
    check_family(cfg)
    act_dtype = getattr(torch, getattr(cfg, "act_dtype", "bfloat16"))
    return {"embed": embed_init(cfg.vocab, cfg.d_model, gen, dtype=act_dtype),
            "final_norm": torch.ones(cfg.d_model, device=gen.device),
            "lm_head": dense_init(cfg.d_model, cfg.vocab, gen),
            "layers": [_dense_layer_params(cfg, gen)
                       for _ in range(max(cfg.n_layers, 1))]}


def _module(tree: dict) -> nn.Module:
    """A nested dict of tensors as an ``nn.Module`` of frozen parameters."""
    m = nn.Module()
    for name, val in tree.items():
        if isinstance(val, dict):
            m.add_module(name, _module(val))
        else:
            m.register_parameter(name, nn.Parameter(val, requires_grad=False))
    return m


class Model(nn.Module):
    """A dense decoder-only LM: ``prefill`` a prompt into a KV cache, then
    ``decode_step`` one token at a time.

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
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)
        self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)
        self.layers = nn.ModuleList(_module(lp) for lp in params["layers"])
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def hidden_states(self, *args, **kwargs):
        raise _not_ported("LM training (hidden_states / act_mode wrapping)")

    def loss(self, *args, **kwargs):
        raise _not_ported("LM training (loss)")

    def _mlp(self, h, lp):
        m = lp.mlp
        return h + swiglu(rmsnorm(h, lp.ln2), m.w_gate, m.w_up, m.w_down)

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
            h = self._mlp(h, lp)
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
            h = self._mlp(h + a, lp)
        cache["pos"] = pos + 1
        return self._logits(h), cache
