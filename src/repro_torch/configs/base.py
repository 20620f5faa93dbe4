"""ArchConfig + assigned input shapes + smoke reduction (the reference's
``repro.configs.base``, copied as plain dataclasses), and
:func:`input_specs`: stand-ins for every step input on the ``meta``
device, in place of the reference's ``ShapeDtypeStruct`` stand-ins."""
from __future__ import annotations

import dataclasses

from repro_torch.core.compressor import CompressionConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual: bool = False
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # ssm
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # encdec / frontends
    encoder_layers: int = 0
    frontend: str | None = None     # "audio" | "vision"
    frontend_len: int = 0
    # training integration
    act_mode: str = "remat"         # none | remat | act
    act_compression: CompressionConfig | None = None
    # host offload of the act-mode stash (None | "host" | "pinned-paged"):
    # compressed_block residuals become host-store tickets so the lax.scan
    # layer loop carries words per layer, not code arrays (repro.offload)
    act_offload: str | None = None
    # dtype the embedding table initializes to — the residual stream
    # inherits it, promoted against the bf16 dense weights (bf16 stays
    # bf16, float32 stays float32, float16 promotes to float32); the
    # activation-memory ledgers size the uncompressed baseline from the
    # promoted dtype
    act_dtype: str = "bfloat16"
    aux_loss_weight: float = 0.01
    # chunking knobs (perf-tunable; see EXPERIMENTS.md §Perf)
    k_chunk: int = 1024
    ssm_chunk: int = 128
    vocab_chunk: int = 2048
    grad_accum: int = 1

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    def shared_attn_sites(self) -> list[int]:
        if self.family != "hybrid":
            return []
        if self.n_layers < 6:
            return [1]
        return list(range(5, self.n_layers - 1, 6))

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        emb = 2 * v * d
        per = 0
        if self.family in ("dense", "vlm", "moe", "encdec"):
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
                + self.n_heads * self.d_head * d
            per += attn
        if self.family in ("dense", "vlm", "encdec"):
            per += 3 * d * self.d_ff
        if self.family == "moe":
            per += d * self.n_experts \
                + self.n_experts * 3 * d * self.moe_d_ff
            if self.dense_residual:
                per += 3 * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            h = di // self.ssm_headdim
            per += 2 * d * di + 2 * d * self.ssm_state + d * h + di * d
        total = emb + per * self.n_layers
        if self.family == "encdec":
            enc_per = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
                + self.n_heads * self.d_head * d + 3 * d * self.d_ff
            total += enc_per * self.encoder_layers
            # cross attention in decoder
            total += (d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                      + self.n_heads * self.d_head * d) * self.n_layers
        if self.family == "hybrid":
            d2 = 2 * d
            total += d2 * (self.n_heads + 2 * self.n_kv_heads) * (d2 // self.n_heads) \
                + d2 * d2 + 3 * d2 * self.d_ff + d2 * d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_experts * 3 * d * self.moe_d_ff \
            * self.n_layers
        return int(dense + self.top_k * 3 * d * self.moe_d_ff * self.n_layers)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch × shape) runs; long_500k gates on sub-quadratic decode
    (DESIGN.md §7)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skipped: pure full-attention arch at 524k context "
                       "(sub-quadratic gate, DESIGN.md §7)")
    return True, ""


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=3 if cfg.family == "hybrid" else 2,
        d_model=64, n_heads=4,
        n_kv_heads=4 if cfg.n_kv_heads == cfg.n_heads else 2,
        d_head=16, d_ff=128, vocab=512,
        k_chunk=32, ssm_chunk=16, vocab_chunk=32, grad_accum=1,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=min(cfg.top_k, 4), moe_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=16, ssm_expand=2)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2)
    if cfg.frontend:
        kw.update(frontend_len=8)
    return dataclasses.replace(cfg, **kw)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Stand-ins for every step input on the ``meta`` device (shapes and
    dtypes, no allocation), under the reference's keys: ``tokens`` (and
    ``enc_embeds`` / ``prefix_embeds``) for train and prefill, ``tokens``
    (B, 1) and the decode ``cache`` (:func:`~repro_torch.models.
    transformer.init_cache` on ``meta``) for decode."""
    import torch

    b, s = shape.batch, shape.seq

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        spec = {"tokens": meta((b, s), torch.int32)}
        if cfg.family == "encdec":
            spec["enc_embeds"] = meta((b, s, cfg.d_model), torch.bfloat16)
        if cfg.frontend == "vision":
            spec["prefix_embeds"] = meta((b, cfg.frontend_len, cfg.d_model),
                                         torch.bfloat16)
        return spec
    from repro_torch.models.transformer import init_cache

    enc_len = min(4096, s) if cfg.family == "encdec" else 0
    return {"tokens": meta((b, 1), torch.int32),
            "cache": init_cache(cfg, b, s, enc_len=enc_len, device="meta")}
